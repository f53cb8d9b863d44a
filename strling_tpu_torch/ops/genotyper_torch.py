"""Expansion genotyper model in torch, batched over loci.

Port of `strling_tpu.ops.genotyper_jax`. The reference genotyper's allele-2
model (genotyper.nim:117-140) is four FLOPs per locus:

    allele2_bp = 2 ** (log2(sum_str_counts / max(1, depth) + 1) * COEF + B)

so the batched form is one vectorized expression over every locus at once,
in float64, on a given device. The scalar host path (core/genotyper.py,
CPython libm) stays the byte-stable production formatter everywhere,
including `call --distributed`; no production path calls this module, as
none calls the JAX one. torch's log2/exp2 may differ from libm in the last
bits (held to <= 64 ulp), ~10 orders of magnitude below the 2-decimal output
precision. The JAX form is XLA, not Pallas, so plain torch ops are its
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

# HTT-simulation-fitted constants (genotyper.nim:117-124,135-140)
ANCHORED_INTERCEPT = 4.3558142
ANCHORED_COEF = 0.7565329
UNPLACED_INTERCEPT = 8.9199168
UNPLACED_COEF = 0.7595562


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64)).to(device)


def genotype_model_batch(sum_str_counts: np.ndarray, depth: np.ndarray,
                         rulen: np.ndarray, device) -> np.ndarray:
    """allele2 estimates (repeat units) for every locus (genotyper.nim:
    117-124 / max(1, rulen)); NaN where sum_str_counts == 0."""
    s, d, r = (_f64(x, device) for x in (sum_str_counts, depth, rulen))
    y = (torch.log2(s / d.clamp(min=1.0) + 1.0) * ANCHORED_COEF
         + ANCHORED_INTERCEPT)
    out = torch.where(s == 0, torch.nan, torch.exp2(y)) / r.clamp(min=1.0)
    return out.cpu().numpy()


def unplaced_model_batch(unplaced: np.ndarray, depth: np.ndarray,
                         rulen: np.ndarray, device) -> np.ndarray:
    """update_genotype's large-allele refinement (genotyper.nim:192-197)."""
    u, d, r = (_f64(x, device) for x in (unplaced, depth, rulen))
    y = torch.log2(u / d + 1.0) * UNPLACED_COEF + UNPLACED_INTERCEPT
    return (torch.exp2(y) / r).cpu().numpy()
