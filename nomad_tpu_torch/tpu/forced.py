"""Plain PyTorch version of the forced-node system kernel, both arms.

The same program as ``nomad_tpu/tpu/engine.py`` ``_build_forced_kernel``
(K4, ``:888-997``): when every placement of a system eval names a
distinct forced node, the eval is one vectorized pass over the placement
axis. Each placement gathers its node's row, checks fit, distinct_hosts
and the feature lane, and scores binpack + anti-affinity: in the int arm
with the Q27 ``e_base * e_ask >> 27`` exponentials and the Q45
reciprocal of the desired count, in the float arm with ``pow(10, x)``,
every divisor a tensor on the inputs' device (as in ``step.py``). It is
what ``kernels.forced_eval`` runs for tensors on the CPU, and what the
CUDA kernel (``csrc/forced_eval.cu``) is held against on the card.

Padded placements carry ``forced_node = -1`` and get ``chosen = -1``.
Returns ``(chosen, scores, pulls, skipped, evict)`` as the scan does:
pulls zero, nothing skipped, an empty evict column.
"""
from __future__ import annotations

import torch

from .encode import DIM_CPU, DIM_MEM
from .intscore import E27_BITS, E27_ONE, FEAT_FEAS_BIT, RECIP_BITS, TERM_BITS, unpack_feat_lane_torch

I32, I64, F32 = torch.int32, torch.int64, torch.float32


def forced_eval(static, carry, xs):
    """K4 over one eval's P placements (the JAX ``forced_eval``
    contract); the inputs are not modified."""
    (totals, reserved, asks, feat_packed, _aff, desired_counts, dh_job, dh_tg,
     *_rest) = static
    n_real, e_ask = static[15], static[16]
    used0, tg_counts0, job_counts0 = carry[0], carry[1], carry[2]
    failed0, e_base0 = carry[6], carry[7]
    tg_idx, forced_node = xs[0], xs[9]

    dev = totals.device
    n_pad = totals.shape[0]
    j = forced_node[:, 0].to(I64)                              # [P]
    g = tg_idx.to(I64)
    jj = j.clamp(0, n_pad - 1)

    ask = asks[g]                                              # [P, D]
    totals_j = totals[jj]
    if reserved.shape[0]:
        reserved_j = reserved[jj]
        util = used0[jj] + reserved_j + ask
    else:
        util = used0[jj] + ask
    fits = (util <= totals_j).all(dim=-1)

    jc = job_counts0[jj]
    tgc = tg_counts0[g, jj]
    dh_mask = torch.where(dh_job[g], jc == 0,
                          torch.where(dh_tg[g], ~((tgc > 0) & (jc > 0)),
                                      torch.ones_like(fits)))
    feasible = (unpack_feat_lane_torch(feat_packed[g, jj], FEAT_FEAS_BIT)
                & fits & dh_mask & (j >= 0) & (j < n_real.to(I64)) & ~failed0[g])

    anti_present = tgc > 0
    if totals.dtype == I32:
        e_sel = (e_base0[jj].to(I64) * e_ask[g, jj].to(I64)) >> E27_BITS   # [P, 2]
        fit = (20 * E27_ONE - e_sel[:, 0] - e_sel[:, 1]).clamp(0, 18 * E27_ONE)
        binpack = torch.div(fit * 4, 9, rounding_mode="floor")
        rsh = RECIP_BITS - TERM_BITS
        q_d = torch.div(torch.full_like(fit, 1 << RECIP_BITS),
                        desired_counts[g].to(I64).clamp(min=1), rounding_mode="floor")
        anti = torch.where(anti_present, -(((tgc.to(I64) + 1) * q_d) >> rsh),
                           torch.zeros_like(fit))
        num_terms = 1 + anti_present.to(I64)
        factor = torch.div(torch.full_like(num_terms, 60), num_terms, rounding_mode="floor")
        final = (binpack + anti) * factor
    else:
        f = lambda v: torch.tensor(v, dtype=F32, device=dev)  # noqa: E731
        one, zero, eps = f(1.0), f(0.0), f(1e-9)
        if reserved.shape[0]:
            node_cpu = totals_j[:, DIM_CPU] - reserved_j[:, DIM_CPU]
            node_mem = totals_j[:, DIM_MEM] - reserved_j[:, DIM_MEM]
        else:
            node_cpu, node_mem = totals_j[:, DIM_CPU], totals_j[:, DIM_MEM]
        free_cpu = one - util[:, DIM_CPU] / torch.maximum(node_cpu, eps)
        free_mem = one - util[:, DIM_MEM] / torch.maximum(node_mem, eps)
        ten = f(10.0)
        fitness = f(20.0) - (torch.pow(ten, free_cpu) + torch.pow(ten, free_mem))
        binpack = torch.minimum(torch.maximum(fitness, zero), f(18.0)) / f(18.0)
        anti = torch.where(anti_present,
                           -(tgc.to(F32) + one) / desired_counts[g].to(F32), zero)
        num_terms = one + anti_present.to(F32)
        final = (binpack + anti) / num_terms

    p = tg_idx.shape[0]
    chosen = torch.where(feasible, j, torch.full_like(j, -1)).to(I32)
    scores = torch.where(feasible, final, torch.zeros_like(final))
    return (chosen, scores, torch.zeros(p, dtype=I32, device=dev),
            torch.zeros(p, dtype=torch.bool, device=dev),
            torch.zeros((p, 0), dtype=I32, device=dev))
