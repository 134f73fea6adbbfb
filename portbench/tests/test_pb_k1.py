"""K1's bound counts the bytes a frame's traversal needs from the frame's
definition."""

from portbench.harness import k1


def test_waves():
    assert k1.waves(3, False) == (3, 4)
    assert k1.waves(3, True) == (3, 7)


def test_headline_frame_bytes():
    slots, tris = 1920 * 1080, 259_874
    got = k1.frame_bytes(slots, 3, False, tris)
    want = (3 * (slots * 32 + tris * 36) + 4 * (slots * 29 + tris * 36))
    assert got == want == 505_091_448


def test_bytes_grow_with_samples_and_probe():
    base = k1.frame_bytes(1000, 3, False, 10)
    assert k1.frame_bytes(2000, 3, False, 10) > base
    assert k1.frame_bytes(1000, 3, True, 10) - base == 3 * (1000 * 29 + 360)
