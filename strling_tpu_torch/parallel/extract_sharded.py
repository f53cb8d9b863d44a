"""Multi-rank sharded extract step.

Port of `strling_tpu.parallel.extract_sharded` onto torch.distributed. The
read stream is data-parallel across ranks; per-rank partial statistics are
combined with collectives over the device mesh (`parallel.mesh.make_mesh`):

- fragment-length histogram: all_reduce (the reference's element-wise
  histogram sum at merge, merge.nim:112-115)
- per-repeat-unit evidence histogram: all_reduce
- per-locus-shard candidate counts: all_gather over the "locus" dim (the
  reference's per-chromosome merge fan-out, merge.nim:89,125)

The scan is the repeat-unit kernel's ASCII entry (`ops.kmer_cuda.repeat_scan`:
the hand-written kernel on a card, the plain form on the CPU); the histograms
are scatter_add_ on the rank's device. The JAX step runs the XLA detector
here; the port runs its kernel, since the card's path never runs the plain
form. `extract_step` is used by the dryrun; production extract runs the same
kernel per rank over its shard of batches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from strling_tpu_torch.ops.kmer import DECODE_ASCII
from strling_tpu_torch.ops.kmer_cuda import repeat_scan
from strling_tpu_torch.parallel.mesh import group_device

_OFFSETS = [0] + [1 + sum(4**m for m in range(1, l)) for l in range(1, 8)]


def unit_code(unit_ascii: torch.Tensor, unit_len: torch.Tensor) -> torch.Tensor:
    """Encode a [B, 6] ASCII unit + length to a dense int id:
    offset(len) + base4-code. len 0 -> id 0 (no repeat)."""
    codes = (unit_ascii.to(torch.int32) >> 1) & 3
    val = torch.zeros(unit_ascii.shape[0], dtype=torch.int32,
                      device=unit_ascii.device)
    for i in range(6):
        val = torch.where(i < unit_len, val * 4 + codes[:, i], val)
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=unit_ascii.device)
    return torch.where(unit_len > 0, offs[unit_len.long()] + val, 0)


N_UNIT_IDS = 1 + sum(4**l for l in range(1, 7))  # 5461


def units_ascii(code: torch.Tensor, unit_len: torch.Tensor) -> torch.Tensor:
    """Base-4 packed unit codes + lengths -> [B, 6] ASCII (zero-padded), on
    their device (ops.kmer.codes_to_ascii's arithmetic)."""
    i = torch.arange(6, device=code.device)
    shift = (2 * (unit_len[:, None] - 1 - i)).clamp(min=0)
    digit = (code[:, None] >> shift) & 3
    dec = torch.from_numpy(DECODE_ASCII.copy()).to(code.device)
    return torch.where(i < unit_len[:, None], dec[digit.long()],
                       0).to(torch.uint8)


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    g = t.to(group_device())
    dist.all_reduce(g, group=group)
    return g.to(t.device)


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    g = t.to(group_device())
    parts = [torch.empty_like(g) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, g, group=group)
    return torch.cat(parts).to(t.device)


def extract_step_local(bases, lengths, thresh_early, thresh_prop, isize,
                       frag_valid, mesh=None):
    """One rank's extract compute on its slice of the batch (bases [b, L]
    uint8 ASCII, lengths [b] int32, thresh_* [b, 5] int32, isize [b],
    frag_valid [b] bool, all on the rank's device) + the cross-rank combines
    over `mesh` (none: this rank alone). Returns (unit [b, 6] uint8,
    unit_len, count) for the slice and the fragment histogram [4096], unit
    histogram [N_UNIT_IDS] and n_str ([n_locus]) of the whole batch, every
    one on the rank's device."""
    code, unit_len, count = repeat_scan(bases, "ascii", lengths,
                                        thresh_early, thresh_prop)
    unit = units_ascii(code, unit_len)
    dev = bases.device

    # fragment-length histogram over proper pairs (utils.nim:86-111 analog)
    isz = isize.clamp(0, 4095).long()
    frag = torch.zeros(4096, dtype=torch.int32, device=dev).scatter_add_(
        0, isz, frag_valid.to(torch.int32))

    # evidence histogram over canonical unit ids
    has = (count > 0).to(torch.int32)
    units_hist = torch.zeros(N_UNIT_IDS, dtype=torch.int32,
                             device=dev).scatter_add_(
        0, unit_code(unit, unit_len).long(), has)
    n_str = has.sum(dtype=torch.int32)[None]

    if mesh is not None:
        dims = mesh.mesh_dim_names
        if "locus" in dims:
            # per-locus-shard candidate counts gathered to every shard (the
            # merge-side all_gather of candidate bounds)
            lg = mesh.get_group("locus")
            n_str = _gather(n_str, lg)
            frag = _reduce(frag, lg)
            units_hist = _reduce(units_hist, lg)
        dg = mesh.get_group("data")
        frag = _reduce(frag, dg)
        units_hist = _reduce(units_hist, dg)
        n_str = _reduce(n_str, dg)
    return unit, unit_len, count, frag, units_hist, n_str


def make_sharded_extract_step(mesh):
    """The extract step over `mesh`. Each rank calls the returned function
    on its slice of the batch: the reads are sharded over every mesh dim,
    rank r holding slice r of `mesh.size()` equal slices (data-major, as
    the JAX step shards them); histograms come back replicated."""

    def extract_step(bases, lengths, thresh_early, thresh_prop, isize,
                     frag_valid):
        return extract_step_local(bases, lengths, thresh_early, thresh_prop,
                                  isize, frag_valid, mesh=mesh)

    return extract_step
