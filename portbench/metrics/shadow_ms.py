"""Device ms a frame of the shadow waves of next-event estimation and of
the final gather (``shade{N}/shadow`` ranges): their sort, K1 any-hit and
the scatter back."""

import re

from portbench.harness.metrics import pass_ms


def read(ctx):
    return pass_ms(ctx, lambda t: re.fullmatch(r"shade\d+/shadow", t)
                   is not None)
