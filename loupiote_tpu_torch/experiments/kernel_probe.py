"""E1: the sub-packet traversal step-cost probe (``csrc/kernel_probe.cu``)
and its plain torch twin (counterpart of the reference's
``kernel_probe.py``: ``probe_trace``, the Pallas ``probe_kernel``).

Each 128-lane row of an (8, 128) ray block is one sub-packet: one node
cursor and one stack for its lanes, a best ``t, u, v, tri`` per lane. The
five variants strip parts of the step to time them; only ``full`` and
``noorder`` return closest hits, the others give wrong results on
purpose, deterministic all the same:
  full      the production step;
  nomt      no leaf Moller-Trumbore tests;
  noorder   children ranked by index, not by distance;
  nostack   no stack pushes (descend only; ends early);
  nofetch   row 0 read every step, exactly ``NOFETCH_STEPS`` steps.

One repair against the reference: its probe predates the ``LEAF_TAG`` bit
on child pointers to leaf rows and followed the raw pointer past the
table's end, so every packet retired at its first leaf child without a
triangle test. The port masks the tag off non-negative pointers.

Run on the card: ``python -m loupiote_tpu_torch.experiments.kernel_probe``.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import check_args, on_card
from ..accel.wide import LEAF_MASK
from ..ops.intersect import T_MIN, moller_trumbore
from ..ops.sort import ray_sort_key, sort_order
from ..ops.wide import _safe_inv
from . import require_card, time_probe
from .measure_traversal import build, make_waves

SUB, SUBP, WIDTH = 8, 128, 8
# Entries of a packet's stack at most (csrc/kernel_probe.cu: kMaxStack):
# each warp keeps its packet's stack in shared memory.
STACK_MAX = 2048
TILE = SUB * SUBP
BIG = 3e30
PROBES = ("full", "nomt", "noorder", "nostack", "nofetch")
NOFETCH_STEPS = 600
REPS = 3  # timed calls of each variant, after one warm-up

# Stack pushes at or beyond stack_size (dropped, as the reference's one-hot
# scatter drops them), per device.
_dropped = _build.kernel_counter("kernel_probe.dropped")


def dropped_pushes(device) -> int:
    """Pushes dropped on ``device`` since the last
    ``_build.reset_counters()``: 0 for every variant but ``nofetch``, whose
    packets push the same children of row 0 every step."""
    return _dropped.read(device)


def max_steps_of(probe: str, wide_end: int) -> int:
    """The reference's step bound for each variant."""
    return NOFETCH_STEPS if probe == "nofetch" else 4 * int(wide_end) + 64


def probe_trace_plain(trav_rows, ox, oy, oz, dx, dy, dz, t0, act, *,
                      end_index: int, max_steps: int, leaf_cap: int,
                      stack_size: int, probe: str, stats: dict | None = None):
    """Plain torch sub-packet traversal, vectorised over the live packets.

    Inputs (G, 8, 128): ray components and ``t0`` float32, ``act`` int32.
    Returns ``(t, u, v, tri, steps)``: (G, 8, 128) float32 t, u, v, int32
    tri (-1 where no hit) and (G, 8) int32 steps per packet. ``stats``:
    receives ``box_tests`` (at an internal row, one per active lane and
    child with a non-negative pointer: an empty slot needs no test),
    ``plane_tests`` (those of ``box_tests`` that the packet's near and far
    planes decide: its active rays have finite origins and one sign of
    each inverse direction component, and the child's box has min <= max
    on each axis) and ``tri_tests`` (triangles an active lane tested at a
    leaf row).
    """
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}")
    dev = ox.device
    G = ox.shape[0]
    n = G * SUB
    o = [x.reshape(n, SUBP) for x in (ox, oy, oz)]
    d = [x.reshape(n, SUBP) for x in (dx, dy, dz)]
    inv = [_safe_inv(x) for x in d]
    act_l = act.reshape(n, SUBP) != 0
    t = t0.reshape(n, SUBP).clone()
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)
    tri = torch.full((n, SUBP), -1, dtype=torch.int32, device=dev)
    rows_i = trav_rows.view(torch.int32)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)
    ptr = torch.zeros(n, dtype=torch.int64, device=dev)
    # Column stack_size is a dump slot for the scatter of dropped pushes.
    stack = torch.zeros((n, stack_size + 1), dtype=torch.int32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.arange(WIDTH, device=dev)
    caps = 0 if probe == "nomt" else leaf_cap
    live = torch.nonzero(act_l.any(dim=1)).flatten()
    # Packets whose active rays share an octant and have finite origins.
    coherent = torch.ones(n, dtype=torch.bool, device=dev)
    for a in range(3):
        coherent &= (torch.isfinite(o[a]) | ~act_l).all(dim=1)
        coherent &= ~(((inv[a] < 0) & act_l).any(dim=1)
                      & ((inv[a] > 0) & act_l).any(dim=1))
    # Work counts kept on the device, read once at the end.
    box_tests = torch.zeros((), dtype=torch.int64, device=dev)
    plane_tests = torch.zeros_like(box_tests)
    tri_tests = torch.zeros_like(box_tests)
    dropped = torch.zeros_like(box_tests)
    for _ in range(max_steps):
        if live.numel() == 0:
            break
        steps[live] += 1
        row = torch.zeros_like(live) if probe == "nofetch" else cur[live]
        rs, rsi = trav_rows[row], rows_i[row]
        leaf = rsi[:, 127] == 1
        nchild = torch.zeros_like(live)
        near = torch.zeros_like(live)

        li = live[leaf]
        if caps and li.numel():
            fc = rsi[leaf, 126]
            lcount, lfirst = fc & 15, fc >> 4
            la = act_l[li]
            ol = tuple(x[li] for x in o)
            dl = tuple(x[li] for x in d)
            tl, ul, vl, tril = t[li], u[li], v[li], tri[li]
            lr = rs[leaf]
            tri_tests += (la.sum(dim=1) * torch.clamp_max(lcount, caps)).sum()
            for k in range(caps):
                valid = la & (k < lcount)[:, None]
                uu, vv, tt = moller_trumbore(
                    ol, dl, tuple(lr[:, 9 * k + j, None] for j in range(9)))
                ok = (valid & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                      & (tt > T_MIN) & (tt < tl))
                tl = torch.where(ok, tt, tl)
                ul = torch.where(ok, uu, ul)
                vl = torch.where(ok, vv, vl)
                tril = torch.where(ok, (lfirst + k)[:, None], tril)
            t[li], u[li], v[li], tri[li] = tl, ul, vl, tril

        node = ~leaf
        ni = live[node]
        if ni.numel():
            box = rs[node].view(-1, WIDTH, 16)
            cptr = rsi[node].view(-1, WIDTH, 16)[:, :, 6]
            on = [x[ni][:, None, :] for x in o]
            iv = [x[ni][:, None, :] for x in inv]
            t1 = [(box[:, :, a, None] - on[a]) * iv[a] for a in range(3)]
            t2 = [(box[:, :, a + 3, None] - on[a]) * iv[a] for a in range(3)]
            tn = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                             torch.minimum(t1[1], t2[1])),
                               torch.minimum(t1[2], t2[2]))
            tf = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                             torch.maximum(t1[1], t2[1])),
                               torch.maximum(t1[2], t2[2]))
            na = act_l[ni][:, None, :]
            nact = act_l[ni].sum(dim=1)
            tested = cptr >= 0
            planes = (tested & coherent[ni][:, None]
                      & (box[:, :, :3] <= box[:, :, 3:6]).all(dim=2))
            box_tests += (tested.sum(dim=1) * nact).sum()
            plane_tests += (planes.sum(dim=1) * nact).sum()
            rhit = ((tf >= torch.clamp_min(tn, 0.0)) & (tn < t[ni][:, None, :])
                    & na)
            tnc = torch.where(rhit, tn, BIG).amin(dim=2)  # (nn, 8)
            hit = (tnc < BIG) & (cptr >= 0)
            ptrs = torch.where(cptr >= 0, cptr & LEAF_MASK, cptr).to(
                torch.int64)
            nch = hit.sum(dim=1)
            if probe == "noorder":
                rank = torch.cumsum(hit, dim=1) - hit.to(torch.int64)
            else:
                # nearer[:, c, q]: child q comes before child c.
                a_, b_ = tnc[:, None, :], tnc[:, :, None]
                nearer = (a_ < b_) | ((a_ == b_)
                                      & (idx[None, :] < idx[:, None]))
                rank = (nearer & hit[:, None, :]).sum(dim=2)
            desc = nch > 0
            if probe != "nostack":
                push = hit & (rank >= 1) & desc[:, None]
                pos_c = ptr[ni][:, None] + nch[:, None] - 1 - rank
                keep = push & (pos_c < stack_size)
                dropped += (push & ~keep).sum()
                col = torch.where(keep, pos_c, stack_size)
                stack[ni[:, None].expand(-1, WIDTH), col] = ptrs.to(
                    torch.int32)
                ptr[ni] += torch.where(desc, nch - 1, 0)
            nchild[node] = nch
            near[node] = torch.where(hit & (rank == 0), ptrs, 0).sum(dim=1)

        # Next row: the nearest hit child, else the stack top, else done.
        desc = nchild > 0
        pos = ptr[live]
        top = torch.clamp_min(pos - 1, 0)
        popped = torch.where(
            top < stack_size,
            stack[live, torch.clamp_max(top, stack_size)].to(torch.int64), 0)
        nxt = torch.where(desc, near,
                          torch.where(pos > 0, popped, end_index))
        ptr[live] = torch.where(desc, pos, top)
        fin = nxt >= end_index
        cur[live] = torch.where(fin, 0, nxt)
        live = live[~fin]
    _dropped.tensor(dev).add_(dropped)
    if stats is not None:
        stats["box_tests"] = int(box_tests)
        stats["plane_tests"] = int(plane_tests)
        stats["tri_tests"] = int(tri_tests)
    return (t.view(G, SUB, SUBP), u.view(G, SUB, SUBP), v.view(G, SUB, SUBP),
            tri.view(G, SUB, SUBP), steps.view(G, SUB))


def _launch(trav_rows, ox, oy, oz, dx, dy, dz, t0, act, *, end_index: int,
            max_steps: int, leaf_cap: int, stack_size: int, probe: str):
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}")
    dev = ox.device
    shape = tuple(ox.shape)
    if len(shape) != 3 or shape[1:] != (SUB, SUBP):
        raise ValueError(f"kernel_probe: rays must be (G, 8, 128), got "
                         f"{shape}")
    check_args(dev, [("trav_rows", trav_rows, torch.float32, None)]
               + [(nm, x, torch.float32, shape) for nm, x in
                  (("ox", ox), ("oy", oy), ("oz", oz), ("dx", dx), ("dy", dy),
                   ("dz", dz), ("t0", t0))]
               + [("act", act, torch.int32, shape)])
    if trav_rows.dim() != 2 or trav_rows.shape[1] != 128:
        raise ValueError("trav_rows: need shape (rows, 128)")
    if not 1 <= stack_size <= STACK_MAX:
        raise ValueError(f"kernel_probe: stack_size {stack_size} outside "
                         f"1..{STACK_MAX}")
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    tri = torch.empty(shape, dtype=torch.int32, device=dev)
    steps = torch.empty(shape[:2], dtype=torch.int32, device=dev)
    # The persistent grid's packet counter.
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.launch("kernel_probe", "kernel_probe", "16p6is", trav_rows, ox, oy,
                  oz, dx, dy, dz, t0, act, t, u, v, tri, steps,
                  _dropped.tensor(dev), nxt, shape[0] * SUB, int(end_index),
                  int(max_steps), int(leaf_cap), int(stack_size),
                  PROBES.index(probe), mode=probe)
    return t, u, v, tri, steps


def probe_trace(trav_rows, ox, oy, oz, dx, dy, dz, t0, act, *, end_index: int,
                max_steps: int, leaf_cap: int, stack_size: int, probe: str):
    """E1 on CUDA tensors, the plain twin on CPU tensors. Returns
    ``(t, u, v, tri, steps)`` as ``probe_trace_plain`` does."""
    fn = _launch if on_card(ox) else probe_trace_plain
    return fn(trav_rows, ox, oy, oz, dx, dy, dz, t0, act, end_index=end_index,
              max_steps=max_steps, leaf_cap=leaf_cap, stack_size=stack_size,
              probe=probe)


def probe_args(bufs, ro, rd, alive):
    """The probe's (G, 8, 128) inputs from (R, 3) rays, R a multiple of
    1024: origin and direction components, ``t0 = 1e30``, ``act`` int32."""
    R = ro.shape[0]
    if R % TILE:
        raise ValueError(f"probe_args: {R} rays is not a multiple of {TILE}")
    G = R // TILE

    def shp(x):
        return x.reshape(G, SUB, SUBP).contiguous()

    return (bufs.trav_rows, *(shp(ro[:, a]) for a in range(3)),
            *(shp(rd[:, a]) for a in range(3)),
            shp(torch.full((R,), 1e30, dtype=torch.float32, device=ro.device)),
            shp(alive.to(torch.int32)))


def probe_kwargs(bufs, probe: str) -> dict:
    return dict(end_index=bufs.wide_end,
                max_steps=max_steps_of(probe, bufs.wide_end),
                leaf_cap=bufs.leaf_cap, stack_size=bufs.wide_stack,
                probe=probe)


def sorted_diffuse_wave(bufs, cam, W: int = 1920, H: int = 1080):
    """The diffuse wave of ``make_waves``, sorted by ``ray_sort_key`` /
    ``sort_order``: ``(dro, drd, alive)``."""
    _, _, dro, drd, alive = make_waves(bufs, cam, W, H)
    order = sort_order(ray_sort_key(dro, drd, alive, bufs.node_min[0],
                                    bufs.node_max[0]))
    return (dro[order].contiguous(), drd[order].contiguous(),
            alive[order].contiguous())


def main(device="cuda", bufs=None, cam=None) -> dict:
    """The probe's path: the arch-260k diffuse wave, sorted, as (2025, 8,
    128) blocks; each variant timed (best of ``REPS`` after a warm-up) and its
    steps per packet printed. ``bufs`` / ``cam``: a scene already built by
    ``measure_traversal.build`` (built here otherwise). Returns
    ``{"inputs": the probe's arguments, "probes": {probe: {"ms",
    "steps_mean", "steps_max", "dropped", "outputs"}}}``, ``outputs`` the
    last call's ``(t, u, v, tri, steps)``."""
    require_card(device)
    if bufs is None:
        bufs, cam = build(device)
    args = probe_args(bufs, *sorted_diffuse_wave(bufs, cam))
    dev = args[1].device
    out = {}
    for probe in PROBES:
        kw = probe_kwargs(bufs, probe)
        before = dropped_pushes(dev)
        ms, outputs = time_probe(lambda: probe_trace(*args, **kw), REPS)
        # REPS + 1 identical calls, the warm-up included.
        dropped = (dropped_pushes(dev) - before) // (REPS + 1)
        steps = outputs[4].float()
        note = (f" (per-step x {NOFETCH_STEPS} fixed)" if probe == "nofetch"
                else "")
        print(f"{probe}: {ms:.3f} ms{note}; steps per packet mean "
              f"{float(steps.mean()):.1f}, max {int(steps.max())}; dropped "
              f"pushes {dropped} a call on {dev}", flush=True)
        out[probe] = {"ms": ms, "steps_mean": float(steps.mean()),
                      "steps_max": int(steps.max()), "dropped": dropped,
                      "outputs": outputs}
    return {"inputs": args, "probes": out}


if __name__ == "__main__":
    main()
