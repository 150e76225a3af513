"""Mesh construction and sharding specs for the placement scan.

The scale axes of this domain map onto a 2-D grid of devices:

  "evals" — data parallelism over independent evaluations (each eval's scan
            is independent; the broker dequeues many at once). The analog of
            DP in an ML workload.
  "nodes" — model/sequence parallelism over the cluster's node axis: every
            [N]-shaped array (capacity, masks, scores) split across
            devices, with the ring-ordered selection exchanged between
            them each step. The analog of TP/SP.

Copied from ``nomad_tpu/parallel/sharding.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. The grid is the reference's, made
over ``torch.device``s (a small :class:`Mesh` in place of
``jax.sharding.Mesh``), and the eval axis is what runs: a
``tpu.batcher.DeviceBatcher`` given a mesh splits each batch into
``evals`` contiguous groups, each packed into its own slab and run as its
own K3 launch (``kernels.place_scan_batched_packed``) on its own stream
of its device. With ``nodes > 1`` each group's padded node axis splits
further into ``nodes`` contiguous slices (``node_slices``): every array
whose spec below names ``"nodes"`` is sliced, everything else is
replicated, and the slices run the node-sharded scan
(``tpu.node_shard``, ``kernels.place_scan_nodes_phase``), whose three
per-step exchanges go between the shards' streams as copies ordered by
events, between launches.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("evals", "nodes")


class Mesh:
    """An ``("evals", "nodes")`` grid of ``torch.device``s. ``shape`` is
    an ordered dict of the axes' sizes, as ``jax.sharding.Mesh.shape``;
    ``devices`` is the ``[evals, nodes]`` grid (a numpy object array).
    A device may appear more than once (two shards on one card)."""

    def __init__(self, grid: np.ndarray) -> None:
        self.devices = grid
        self.shape = OrderedDict(zip(AXES, grid.shape))


def visible_devices(kind: str = "cuda") -> List[torch.device]:
    """The devices a mesh is made over by default: every visible CUDA
    device (none without CUDA), or for ``"cpu"`` the one CPU."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"visible_devices: unsupported device type {kind!r}")
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, eval_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("evals", "nodes") mesh over ``devices`` (default: every
    visible CUDA device), the first ``n_devices`` of them when given."""
    if devices is None:
        devices = visible_devices("cuda")
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=")
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    ep = max(1, min(eval_parallel, n))
    while n % ep != 0:
        ep -= 1
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(ep, n // ep))


def node_slices(n_pad: int, nodes: int) -> List[Tuple[int, int]]:
    """The contiguous ``[lo, hi)`` slice of a padded node axis of
    ``n_pad`` nodes that each of ``nodes`` shards holds, in shard order:
    equal slices, as the reference's even split of a ``"nodes"``-sharded
    axis (the batcher rounds ``n_pad`` to a multiple of ``nodes``)."""
    if nodes < 1 or n_pad % nodes:
        raise ValueError(f"node_slices: {n_pad} nodes do not split evenly over {nodes} shards")
    per = n_pad // nodes
    return [(k * per, (k + 1) * per) for k in range(nodes)]


def batched_scan_shardings(mesh: Mesh):
    """(static, carry, xs) axis specs for the FULLY-batched scan, one per
    array of the packed slab in ``kernels.SCAN_STATIC`` / ``SCAN_CARRY`` /
    ``SCAN_XS`` order: each spec names, axis by axis, ``"evals"``,
    ``"nodes"`` or None (kept whole within a shard), as the reference's
    ``PartitionSpec``s do. Every array carries a leading eval axis
    (concurrent evals see different snapshots/node sets/jobs, so node
    tables batch too); small per-TG/spread tables replicate within an
    eval shard. ``mesh`` is taken for the reference's signature: the
    specs do not depend on its sizes."""
    del mesh
    e, n = "evals", "nodes"
    static = (
        (e, n, None),              # totals [B, N, D]
        (e, n, None),              # reserved [B, N, D]
        (e, None, None),           # asks [B, G, D]
        (e, None, n),              # feat_packed [B, G, N] (uint8 lanes)
        (e, None, n),              # aff_score [B, G, N]
        (e, None),                 # desired_counts [B, G]
        (e, None),                 # dh_job [B, G]
        (e, None),                 # dh_tg [B, G]
        (e, None),                 # limits [B, G]
        (e, None, None, n),        # spread_vids [B, G, S, N]
        (e, None, None, None),     # spread_desired [B, G, S, V]
        (e, None, None),           # spread_weights [B, G, S]
        (e, None, None),           # spread_has_targets [B, G, S]
        (e, None, None),           # spread_active [B, G, S]
        (e, None),                 # sum_spread_weights [B, G]
        (e,),                      # n_real [B]
        (e, None, n, None),        # e_ask [B, G, N, 2]
        (e, None, n),              # dp_vids [B, D, N]
        (e, None),                 # dp_limit [B, D]
        (e, None, None),           # dp_applies [B, G, D]
        (e, n, None, None),        # pre_res [B, N, C, 4]
        (e, n, None),              # pre_prio [B, N, C]
        (e, n, None),              # pre_elig [B, N, C]
        (e, n, None),              # pre_mp [B, N, C]
        (e, n, None),              # pre_gid [B, N, C]
        (e, n, None, None),        # pre_evf [B, N, C, 2]
    )
    carry = (
        (e, n, None),              # used [B, N, D]
        (e, None, n),              # tg_counts [B, G, N]
        (e, n),                    # job_counts [B, N]
        (e, None, None, None),     # spread_counts [B, G, S, V]
        (e, None, None, None),     # spread_entry [B, G, S, V]
        (e,),                      # offset [B]
        (e, None),                 # failed [B, G]
        (e, n, None),              # e_base [B, N, 2]
        (e, None, None),           # dp_counts [B, D, V]
        (e, n, None),              # pre_alive [B, N, C]
        (e, n, None),              # pre_remaining [B, N, 3]
        (e, None),                 # pre_counts [B, GP]
    )
    xs = (
        (e, None),                 # tg_idx [B, P]
        (e, None, None),           # penalty_idx [B, P, K]
        (e, None),                 # evict_node [B, P]
        (e, None, None),           # evict_res [B, P, D]
        (e, None),                 # evict_tg [B, P]
        (e, None),                 # limit_p [B, P]
        (e, None),                 # sum_sw_p [B, P]
        (e, None, None),           # ev_factor [B, P, 2]
        (e, None, None),           # rev_factor [B, P, 2]
        (e, None, None),           # forced_node [B, P, W]
    )
    return static, carry, xs


#: per array of the packed slab (``batched_scan_shardings`` order), the
#: axis its spec names ``"nodes"`` (counting the leading eval axis), or
#: None where the array is replicated over the node axis
NODE_AXES = tuple(spec.index("nodes") if "nodes" in spec else None
                  for part in batched_scan_shardings(None) for spec in part)


def batched_place_scan(mesh: Mesh):
    """The mesh-sharded, eval-batched placement scan: a callable that
    takes a list of ``EncodedEval``s of one dtype and returns ``(chosen,
    scores, pulls, skipped, evict)``, each ``[len(encs), P_pad, ...]``,
    in eval order. It splits the batch over the mesh's ``evals`` axis
    and, where ``nodes > 1``, each group's node axis over ``nodes``
    shards (``tpu.batcher.ShardLauncher``, which the ``DeviceBatcher``
    given this mesh uses), as the reference wraps its one builder
    (engine._build_batched_scan) in the mesh's shardings."""
    from ..tpu.batcher import ShardLauncher, batch_dims

    launcher = ShardLauncher(mesh)

    def scan(encs):
        b_pad = launcher.round_batch(len(encs))
        return launcher(encs, batch_dims(encs, launcher.nodes), b_pad)

    return scan
