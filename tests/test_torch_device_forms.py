"""The port's device forms with no production caller (`ops.cluster_torch`,
`ops.genotyper_torch`) against their scalar host specs and the JAX
package's forms (`strling_tpu.ops.cluster_jax`, `ops.genotyper_jax`)."""

import math

import numpy as np
import pytest
import torch

from strling_tpu.core.cluster_batched import segment_group
from strling_tpu.core.genotyper import anchored_lm, unplaced_est
from strling_tpu.ops.cluster_jax import segment_ids as ref_segment_ids
from strling_tpu.ops.genotyper_jax import genotype_model_batch as ref_genotype
from strling_tpu.ops.genotyper_jax import unplaced_model_batch as ref_unplaced
from strling_tpu_torch.ops.cluster_torch import segment_ids
from strling_tpu_torch.ops.genotyper_torch import (
    genotype_model_batch,
    unplaced_model_batch,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _ids_from_segs(segs, n):
    ids = np.empty(n, np.int32)
    for k, (a, b) in enumerate(segs):
        ids[a:b] = k
    return ids


def _clumps(rng):
    pos = []
    for _ in range(int(rng.integers(1, 8))):
        c = int(rng.integers(0, 3_000_000))
        pos.extend(c + rng.integers(0, 1500, int(rng.integers(1, 40))))
    return np.sort(np.array(pos, np.int64))


@pytest.mark.parametrize("seed", range(4))
def test_segment_ids_matches_host_and_jax_fuzz(seed):
    rng = np.random.default_rng(29 + seed)
    for trial in range(8):
        pos = _clumps(rng)
        max_dist = int(rng.choice([150, 400, 650]))
        want = _ids_from_segs(segment_group(pos, max_dist), len(pos))
        got = segment_ids(pos, max_dist, CPU)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(got, ref_segment_ids(pos, max_dist))


@pytest.mark.parametrize("pos", [
    [5],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 404, 405, 2000],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 403, 404, 804, 2000],
    list(range(0, 4000, 37)),
], ids=["one", "thr8_boundary", "thr9_boundary", "long_run"])
def test_segment_ids_boundaries(pos):
    """One read, and the exact-threshold cases around the 9-read freeze
    (max_dist 300: D = 400)."""
    pos = np.array(pos, np.int64)
    want = _ids_from_segs(segment_group(pos, 300), len(pos))
    np.testing.assert_array_equal(segment_ids(pos, 300, CPU), want)
    np.testing.assert_array_equal(segment_ids(pos, 300, CPU, pad_to=512),
                                  want)


def _within_64_ulp(got, want):
    return got == want or abs(got - want) <= 64 * np.spacing(want)


def test_genotype_model_matches_scalar_and_jax():
    rng = np.random.default_rng(7)
    ssc = rng.integers(0, 3000, 500)
    depth = rng.uniform(0.5, 80.0, 500).round(1)
    rulen = rng.integers(1, 7, 500)
    got = genotype_model_batch(ssc, depth, rulen, CPU)
    jax_got = ref_genotype(ssc, depth, rulen)
    assert got.dtype == np.float64
    for i in range(500):
        want = anchored_lm(int(ssc[i]), float(depth[i])) / max(1, int(rulen[i]))
        if math.isnan(want):
            assert math.isnan(got[i]) and math.isnan(jax_got[i])
        else:
            assert _within_64_ulp(got[i], want)
            assert _within_64_ulp(got[i], jax_got[i])


def test_unplaced_model_matches_scalar_and_jax():
    rng = np.random.default_rng(9)
    unp = rng.integers(3, 500, 200)
    depth = rng.uniform(1.0, 60.0, 200).round(1)
    rulen = rng.integers(1, 7, 200)
    got = unplaced_model_batch(unp, depth, rulen, CPU)
    jax_got = ref_unplaced(unp, depth, rulen)
    for i in range(200):
        want = unplaced_est(int(unp[i]), float(depth[i])) / int(rulen[i])
        assert _within_64_ulp(got[i], want)
        assert _within_64_ulp(got[i], jax_got[i])
