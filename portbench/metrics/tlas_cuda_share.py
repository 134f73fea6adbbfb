"""Share of a two-level frame's instance-loop calls that took the card's
path (``csrc/tlas_traverse.cu`` for the K2 BLASes), in %: the program's
counter ``("tlas_path", "cuda" | "plain")``, one a call, as
``100 * cuda / (cuda + plain)``. None where the program counts no call
(a flattened scene, or a program without the counter).
Read from stretches of frames with the program's recording on
(``harness/hostspans.py``)."""

from portbench.harness import hostspans


def read(ctx):
    calls = hostspans.reading(ctx, "count:tlas_path")
    if not calls:
        return None
    return 100.0 * (hostspans.reading(ctx, "count:tlas_path:cuda") or 0.0) \
        / calls
