"""The least bytes one frame's kernel K1 work needs (the wide traversal,
``loupiote_tpu_torch/csrc/wide_traverse.cu``), counted from the frame's
definition, not from the program's twins or counters.

A frame of ``bounces`` bounces with next-event estimation traces one
closest-hit wave a bounce and one shadow (any-hit) wave a bounce for the
light sample, one more for the last bounce's final gather, and with a
probe one more a bounce for the environment sample. Each wave has
``slots`` = width x height x samples rays: an upper count of what the
frame needs, since rays of finished paths need no traversal. A wave
reads each ray once (origin and direction, 24 bytes; an any-hit query
also its segment length, 4 bytes), writes each answer once (closest hit:
t and triangle, 8 bytes; any-hit: one byte) and reads the scene's
triangles once (three vertices, 36 bytes each). Operations are left out:
they follow the tree the program builds. So the bound is bytes.
"""

RAY_BYTES = 24
SEGMENT_BYTES = 4
HIT_BYTES = 8
BLOCKED_BYTES = 1
TRIANGLE_BYTES = 36


def waves(bounces: int, probe: bool) -> tuple:
    """(closest-hit waves, any-hit waves) of one frame."""
    return bounces, bounces + 1 + (bounces if probe else 0)


def frame_bytes(slots: int, bounces: int, probe: bool, triangles: int) -> int:
    closest, anyhit = waves(bounces, probe)
    scene = triangles * TRIANGLE_BYTES
    return (closest * (slots * (RAY_BYTES + HIT_BYTES) + scene)
            + anyhit * (slots * (RAY_BYTES + SEGMENT_BYTES + BLOCKED_BYTES)
                        + scene))
