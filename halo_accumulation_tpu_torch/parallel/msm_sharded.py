"""Multi-GPU MSM: the points split across the ranks of a torch.distributed
process group.

Counterpart of `halo_accumulation_tpu/parallel/msm_sharded.py`.  Each rank
computes the per-window bucket sums of its contiguous slice of the points
with the staged pipeline's stage 1 (`ops/msm._bucket_sums_chunk`); the
(3, W, 18, B) partial stacks are all-gathered, tree-added rank by rank
with complete adds (group addition is no reduction a collective knows, so
this is an all-gather and a local tree rather than an all-reduce), and
every rank runs the weighting and the window combine itself: the result
is the same point on every rank.  The exchange is O(W B) points whatever
N is.  The mesh paths of pcdl and acc use the same exchange for their
rows and for the fold's partial L and R (gather_rows, gather_lanes,
sum_over_ranks, all_true).

The mesh is a 1-D `torch.distributed.device_mesh.DeviceMesh` whose one
dimension is named AXIS.  Its backend follows the tensors' device: NCCL on
the card, gloo on the CPU.  `init_process_group` forms a group from an
explicit address (a FileStore path or tcp://127.0.0.1:<port>, so no
network is needed); `make_mesh` without a group forms a one-rank group in
memory.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from halo_accumulation_tpu_torch.ops import curve as cv, msm as msm_mod

AXIS = "shards"


def _device_type(devices) -> str:
    """"cuda" or "cpu" from a device, a device type or a list of either;
    None: the card when there is one."""
    if devices is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(devices, (list, tuple)):
        devices = devices[0]
    return torch.device(devices).type


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_process_group(rank: int, world_size: int, init_method: str, devices=None) -> None:
    """Join the process group of world_size ranks at init_method
    (file:///path or tcp://127.0.0.1:<port>) as rank, with NCCL for the
    card and gloo for the CPU; on the card rank r takes card r."""
    dtype = _device_type(devices)
    if dtype == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(_backend(dtype), init_method=init_method, rank=rank, world_size=world_size)


def make_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """A 1-D mesh named AXIS over the first n_devices ranks of the process
    group (all of them by default).  devices: where the mesh's tensors
    live ("cuda" or "cpu", a torch.device or a list of them); by default the
    card when there is one.  Without a process group, a one-rank group is
    formed in this process on an in-memory store (no file, no socket)."""
    dtype = _device_type(devices)
    if not dist.is_initialized():
        dist.init_process_group(_backend(dtype), store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size() if n_devices is None else n_devices
    return DeviceMesh(dtype, torch.arange(n), mesh_dim_names=(AXIS,))


def shard_points(Pv: cv.PointVec, mesh: DeviceMesh) -> cv.PointVec:
    """This rank's contiguous slice of the points' columns: N / size of them."""
    nd, r = mesh.size(), mesh.get_local_rank(AXIS)
    N = Pv.x.shape[1]
    assert N % nd == 0, "point count must divide the mesh"
    w = N // nd
    return cv.PointVec(*(a[:, r * w : (r + 1) * w].contiguous() for a in Pv))


def _all_gather(stacked, mesh: DeviceMesh):
    """A tensor of one shape on every rank, e.g. (3, W, 18, B) -> (size,
    3, W, 18, B), rank order."""
    nd = mesh.size()
    stacked = stacked.contiguous()
    out = stacked.new_empty((nd * stacked.shape[0],) + tuple(stacked.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, stacked, group=mesh.get_group(AXIS))
    return out.reshape((nd,) + tuple(stacked.shape))


def gather_rows(local, mesh: DeviceMesh):
    """(b, ...) on every rank -> (size * b, ...), rank order; bool rows go
    over as int64 (gloo has no bool collectives)."""
    got = _all_gather(local.to(torch.int64), mesh)
    got = got.reshape((-1,) + tuple(local.shape[1:]))
    return got.bool() if local.dtype == torch.bool else got


def gather_lanes(a, mesh: DeviceMesh):
    """(18, w) lanes on every rank -> (18, size * w), rank order."""
    return _all_gather(a, mesh).permute(1, 0, 2).reshape(a.shape[0], -1)


def all_true(ok, mesh: DeviceMesh):
    """The AND over the ranks of a bool (a 0-dim tensor), on every rank."""
    t = ok.to(torch.int64).reshape(1).clone()
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.get_group(AXIS))
    return t[0].bool()


def sum_over_ranks(P: cv.PointVec, mesh: DeviceMesh) -> cv.PointVec:
    """Each rank's points (18, B) summed over the ranks, the same tree as
    msm_sharded's: -> (18, B) on every rank."""
    out = _tree_add(_all_gather(torch.stack([c[None] for c in P]), mesh))  # (3, 1, 18, B)
    return cv.PointVec(out[0, 0], out[1, 0], out[2, 0])


def _tree_add(allp):
    """Complete-add the rank axis of (k, 3, W, 18, B) partial stacks, halves
    against halves as the JAX package's tree: -> (3, W, 18, B)."""

    def as_pv(arr):  # (k, 3, W, 18, B) -> PointVec of (18, k, W, B)
        return cv.PointVec(*(arr[:, i].movedim(2, 0) for i in range(3)))

    cur = allp
    while cur.shape[0] > 1:
        n = cur.shape[0]
        half = n // 2
        s = cv.padd(as_pv(cur[:half]), as_pv(cur[half : 2 * half]))
        s = torch.stack([a.movedim(0, 2) for a in s], dim=1)  # (half, 3, W, 18, B)
        if n % 2:
            s = torch.cat([s, cur[2 * half :]])
        cur = s
    return cur[0]


def msm_sharded(points: cv.PointVec, scalars, mesh: DeviceMesh, c: int | None = None) -> cv.PointVec:
    """sum_i scalars_i * points_i with the points split over mesh's ranks.
    points: this rank's shard (shard_points); scalars: all N of them
    (18, N), the same on every rank.  Digits and one pad, measured over all
    N points (an upper bound of every rank's counts), then each rank's
    bucket sums, the all-gather and the tree, and the weighting and window
    combine on every rank.  Returns the same projective point on every
    rank."""
    nd, r = mesh.size(), mesh.get_local_rank(AXIS)
    N = scalars.shape[1]
    assert N % nd == 0, "point count must divide the mesh"
    w = N // nd
    assert points.x.shape[1] == w, "points must be this rank's shard (shard_points)"
    if c is None:
        c = msm_mod.window_size(w)
    digits = msm_mod._digits(scalars, c)
    pad = msm_mod._measure_pad(digits, c, "sh")
    B = 1 << c
    assert B * pad * msm_mod.num_windows(c) <= msm_mod._SCATTER_BUDGET_COLS * 4, (
        "sharded MSM scatter would exceed the memory budget; shard more devices or lower c"
    )
    S = msm_mod._bucket_sums_chunk(points, digits[:, r * w : (r + 1) * w], c, pad)  # (W, 18, B) x 3
    out = _tree_add(_all_gather(torch.stack(S), mesh))
    return msm_mod._weight_and_combine(tuple(out[i] for i in range(3)), c)
