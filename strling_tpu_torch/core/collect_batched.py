"""Batched per-locus support collection (production call path).

Computes, for every locus at once, exactly the quantities `genotype` consumes
from the per-record `spanners` pass (collect.nim:130-182 — vectorized here
over numpy read batches instead of per-read Python):

- spanning-READ rows (repeat count within bounds + CIGAR indel sum) in read
  order (collect.nim:96-116),
- the spanning-FRAGMENT count from complete pairs (collect.nim:36-48,175-179),
- the window's median depth (diff-array, utils.nim:148-158),
- the expected spanning-fragment sum (per-qname sequential averaging in read
  order, then a float32 accumulation in first-seen qname order,
  collect.nim:144-149,172-173),
- the total support count (for call.nim's len>5000 guard) and the 20k
  distinct-pair abort (collect.nim:167-170).

`collect.spanners` / `spanners_reference` remain the executable spec: the
equivalence tests (tests/test_collect_batched.py) assert every field above,
bit-for-bit (the float32 fold runs in native code with the exact rounding
chain of the spec: f32(f64(acc) + v)).

The debug evidence files (-spanning.txt) need the full Support rows incl.
percentiles, so `call --debug` keeps the spec path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from strling_tpu_torch.core.cluster import Bounds
from strling_tpu_torch.core.collect import _bounds_slop
from strling_tpu_torch.core.spanning import cumulative
from strling_tpu_torch.core.tread import (
    FLAG_DUP,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
)
from strling_tpu_torch.utils.fraglen import median_depth

_SKIP_FLAGS = FLAG_SECONDARY | FLAG_SUPPLEMENTARY | FLAG_DUP

# cigar op -> consumes query / consumes ref (MIDNSHP=X; collect.nim:50-71)
_CQ = np.zeros(16, bool)
_CQ[[0, 1, 4, 7, 8]] = True
_CR = np.zeros(16, bool)
_CR[[0, 2, 3, 7, 8]] = True


@dataclass
class LocusSupport:
    """Everything `genotype` reads from a locus's Support list, as arrays."""

    n_support: int = 0          # len(spans): overlap reads + gated fragments
    n_spanning_reads: int = 0   # rows with Type == SpanningRead
    n_spanning_pairs: int = 0   # rows with Type == SpanningFragment
    span_rc: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    span_ind: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    med_depth: int = -1
    expected: np.float32 = np.float32(0)
    n_records: int = 0          # records the native query decoded


def _f32_seq_sum(vals: np.ndarray) -> np.float32:
    """float32 left-to-right fold over float64 values: acc = f32(f64(acc)+v)
    (collect.nim:172-173). Native helper; tiny-n numpy fallback."""
    try:
        import ctypes as C

        from strling_tpu_torch.io.bam import _load

        lib = _load()
        if not hasattr(lib.sio_f32_seq_sum, "_bound"):
            lib.sio_f32_seq_sum.restype = C.c_float
            lib.sio_f32_seq_sum.argtypes = [
                np.ctypeslib.ndpointer(np.float64), C.c_int64,
            ]
            lib.sio_f32_seq_sum._bound = True
        return np.float32(
            lib.sio_f32_seq_sum(np.ascontiguousarray(vals, np.float64),
                                len(vals))
        )
    except Exception:
        acc = np.float32(0)
        for v in vals:
            acc = np.float32(np.float64(acc) + v)
        return acc


class _Component:
    """Concatenated, coordinate-ordered arrays of one cached read stream.

    `masks` (optional, parallel to `batches`) selects the rows to keep —
    streaming callers pass the union of the chunk's window memberships so
    reads in the gaps between loci are never copied or interned.
    """

    __slots__ = (
        "pos", "end_pos", "flag", "mapq", "tid", "mate_tid", "isize",
        "read_len", "ins8", "del8", "seq", "cigar", "cigar_off", "qid",
        "n",
    )

    def __init__(self, batches, masks=None):
        if not batches:
            batches = []
        if masks is None:
            masks = [np.ones(len(b), bool) for b in batches]
        sel = [np.flatnonzero(m) for m in masks]
        self.n = sum(len(s) for s in sel)
        cat = lambda f, dt: (
            np.concatenate(
                [getattr(b, f)[s].astype(dt) for b, s in zip(batches, sel)]
            )
            if batches else np.zeros(0, dt)
        )
        self.pos = cat("pos", np.int64)
        self.end_pos = cat("end_pos", np.int64)
        self.flag = cat("flag", np.int64)
        self.mapq = cat("mapq", np.int64)
        self.tid = cat("tid", np.int64)
        self.mate_tid = cat("mate_tid", np.int64)
        self.isize = cat("isize", np.int64)
        self.read_len = cat("read_len", np.int64)
        # uint8 CIGAR I/D accumulation wraps per-op in the reference
        # (collect.nim:107-111) — masked addition is a homomorphism mod 256,
        # so the native full sums reduce exactly
        self.ins8 = cat("ins_sum", np.int64) & 0xFF
        self.del8 = cat("del_sum", np.int64) & 0xFF
        if batches:
            W = max(b.seq.shape[1] for b in batches)
            self.seq = np.zeros((self.n, W), np.uint8)
            o = 0
            for b, s in zip(batches, sel):
                self.seq[o : o + len(s), : b.seq.shape[1]] = b.seq[s]
                o += len(s)
            # gathered cigar: per-batch row gather via repeat/cumsum
            cig_parts = []
            offs = [np.zeros(1, np.int64)]
            base = 0
            for b, s in zip(batches, sel):
                cnt = (b.cigar_off[s + 1] - b.cigar_off[s]).astype(np.int64)
                total = int(cnt.sum())
                if total:
                    off0 = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                    intra = np.arange(total) - np.repeat(off0, cnt)
                    cig_parts.append(
                        b.cigar[np.repeat(b.cigar_off[s], cnt) + intra]
                    )
                offs.append(np.cumsum(cnt) + base)
                base += total
            self.cigar = (
                np.concatenate(cig_parts) if cig_parts
                else np.zeros(0, np.uint32)
            )
            self.cigar_off = np.concatenate(offs)
        else:
            self.seq = np.zeros((0, 0), np.uint8)
            self.cigar = np.zeros(0, np.uint32)
            self.cigar_off = np.zeros(1, np.int64)
        # integer qname ids. Only equality classes matter (grouping and the
        # distinct-pair count; every order used downstream is positional),
        # so the sorted-unique numbering from np.unique is fine — and fully
        # vectorized: pad qnames into a fixed-width byte matrix, view rows
        # as opaque scalars, unique(return_inverse).
        if self.n:
            lens_parts = []
            start_parts = []
            blobs = []
            base = 0
            for b, s in zip(batches, sel):
                lens_parts.append(
                    (b.qname_off[s + 1] - b.qname_off[s]).astype(np.int64)
                )
                start_parts.append(b.qname_off[s].astype(np.int64) + base)
                blobs.append(b.qname_blob[: b.qname_off[-1]])
                base += int(b.qname_off[-1])
            lens_q = np.concatenate(lens_parts)
            starts_q = np.concatenate(start_parts)
            buf = np.frombuffer(b"".join(blobs), np.uint8)
            Q = max(1, int(lens_q.max()))
            mat = np.zeros((self.n, Q), np.uint8)
            total = int(lens_q.sum())
            off0 = np.concatenate([[0], np.cumsum(lens_q)[:-1]])
            intra = np.arange(total) - np.repeat(off0, lens_q)
            rows = np.repeat(np.arange(self.n), lens_q)
            mat[rows, intra] = buf[np.repeat(starts_q, lens_q) + intra]
            view = np.ascontiguousarray(mat).view(
                np.dtype((np.void, Q))
            ).ravel()
            _, self.qid = np.unique(view, return_inverse=True)
            self.qid = self.qid.astype(np.int64)
        else:
            self.qid = np.zeros(0, np.int64)


def _find_read_positions(comp: _Component, idx: np.ndarray,
                         position: np.ndarray) -> np.ndarray:
    """Vectorized find_read_position (collect.nim:50-71) for reads idx at
    per-read reference positions. Returns -1 where unprojectable."""
    n = len(idx)
    if n == 0:
        return np.zeros(0, np.int64)
    starts = comp.cigar_off[idx].astype(np.int64)
    counts = (comp.cigar_off[idx + 1] - starts).astype(np.int64)
    Cmax = int(counts.max()) if n else 0
    lens = np.zeros((n, Cmax), np.int64)
    ops = np.zeros((n, Cmax), np.int64)
    rows = np.repeat(np.arange(n), counts)
    total = int(counts.sum())
    off0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cols = np.arange(total) - np.repeat(off0, counts)
    flat_idx = np.repeat(starts, counts) + cols
    packed = comp.cigar[flat_idx].astype(np.int64)
    lens[rows, cols] = packed >> 4
    ops[rows, cols] = packed & 0xF

    r_off = comp.pos[idx].copy()
    q_off = np.zeros(n, np.int64)
    done = np.zeros(n, bool)
    res = np.full(n, -1, np.int64)
    for j in range(Cmax):
        active = ~done & (j < counts)
        if not active.any():
            break
        # if r_off > position: return -1
        ret = active & (r_off > position)
        done |= ret
        active &= ~ret
        ln = lens[:, j]
        op = ops[:, j]
        cq = _CQ[op]
        cr = _CR[op]
        q_off += np.where(active & cq, ln, 0)
        r_off += np.where(active & cr, ln, 0)
        fin = active & ~(r_off < position)
        over = r_off - position
        good = fin & (over <= q_off) & cq
        res[good] = (q_off - over)[good]
        done |= fin
    return res


def _spanning_read_rows(comp: _Component, span_idx: np.ndarray,
                        bounds: Bounds,
                        with_rc: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """repeat-count and indel columns for the locus's spanning reads, in
    read order (collect.nim:74-92,96-116). genotype consumes only the indel
    column (the rc modes are computed-but-unused in the reference's
    genotyper), so production callers pass with_rc=False and skip the
    CIGAR projection + substring count; the equivalence tests keep it on."""
    n = len(span_idx)
    rc = np.zeros(n, np.int64)
    ind = (comp.ins8[span_idx] - comp.del8[span_idx]).astype(np.int64)
    if not with_rc or bounds.right < bounds.left or n == 0:  # collect.nim:75
        return rc, ind
    # one fused projection call for both edges (halves the call overhead)
    both = _find_read_positions(
        comp,
        np.concatenate([span_idx, span_idx]),
        np.concatenate([
            np.full(n, bounds.left, np.int64),
            np.full(n, bounds.right, np.int64),
        ]),
    )
    left_proj, right_proj = both[:n], both[n:]
    rep = bounds.repeat.encode()
    k = len(rep)
    dlen = np.minimum(comp.read_len[span_idx], comp.seq.shape[1])
    rl = left_proj.copy()
    rr = right_proj.copy()
    rr[(rl >= 0) & (rr < 0)] = dlen[(rl >= 0) & (rr < 0)]
    skip = (rl < 0) & (rr < 0)
    rl[rl < 0] = 0
    for i in range(n):
        if skip[i]:
            continue
        row = comp.seq[span_idx[i]]
        S = row[rl[i] : rr[i]].tobytes()
        c = S.count(rep)
        if c < int(len(S) * 0.7 / k):  # purity gate, collect.nim:89-91
            c = 0
        rc[i] = c & 0xFF
    return rc, ind


def _collect_one(comp: _Component, b: Bounds, window: int, cd: np.ndarray,
                 frag_sizes: np.ndarray, min_mapq: int, max_size: int,
                 with_rc: bool = False) -> LocusSupport:
    wl = b.left - window
    wr = b.right + window
    ls = LocusSupport()

    # membership with htslib query semantics (end_pos > start and pos < end)
    hi = int(np.searchsorted(comp.pos, wr, side="left"))
    member = comp.end_pos[:hi] > max(0, wl)
    m = np.flatnonzero(member)
    if len(m) == 0:
        ls.med_depth = median_depth(np.zeros(wr - wl, np.int64))
        return ls

    flag = comp.flag[m]
    keep = ((flag & _SKIP_FLAGS) == 0) & (comp.mapq[m] >= min_mapq)
    k = m[keep]
    if len(k) == 0:
        ls.med_depth = median_depth(np.zeros(wr - wl, np.int64))
        return ls
    start = comp.pos[k]
    stop = comp.end_pos[k]
    kflag = comp.flag[k]

    # expected spanning probability (spanning.nim:20-49), vectorized
    rev = (kflag & FLAG_REVERSE) != 0
    left_case = start < (b.right - 20)
    ev = b.right - b.left
    dist_l = b.left - start
    dist_r = stop - b.right
    ok_l = left_case & ~rev & (dist_l >= 0) & (dist_l + ev >= 20)
    ok_r = ~left_case & rev & (dist_r >= 0) & (dist_r + ev >= 20)
    dist = np.where(left_case, dist_l, dist_r) + 20 + ev
    ok = (ok_l | ok_r) & (dist >= 0) & (dist <= len(cd) - 1)
    probs = np.zeros(len(k), np.float64)
    probs[ok] = 1.0 - cd[dist[ok]].astype(np.float64)

    # depth diff-array -> median (collect.nim:151-153)
    depths = np.zeros(wr - wl, np.int64)
    np.add.at(depths, np.maximum(0, start - wl - 1), 1)
    np.add.at(depths, np.minimum(len(depths) - 1, stop - wl - 1), -1)
    ls.med_depth = median_depth(np.cumsum(depths))

    # expected: per-qname sequential averaging of positive probs in read
    # order, then the f32 fold in first-seen qname order
    # (collect.nim:144-149,172-173)
    posi = np.flatnonzero(probs > 0)
    if len(posi):
        q = comp.qid[k[posi]]
        p = probs[posi]
        order = np.argsort(q, kind="stable")
        qs = q[order]
        newg = np.empty(len(qs), bool)
        newg[0] = True
        newg[1:] = qs[1:] != qs[:-1]
        starts_g = np.flatnonzero(newg)
        ends_g = np.append(starts_g[1:], len(qs))
        cnt_g = ends_g - starts_g
        vals = np.empty(len(starts_g), np.float64)
        one = cnt_g == 1
        vals[one] = p[order[starts_g[one]]]
        two = cnt_g == 2
        vals[two] = 0.5 * (p[order[starts_g[two]]] + p[order[starts_g[two] + 1]])
        for gi in np.flatnonzero(cnt_g > 2):  # >2 same-qname reads: rare
            acc = p[order[starts_g[gi]]]
            for j in range(starts_g[gi] + 1, ends_g[gi]):
                acc = 0.5 * (acc + p[order[j]])
            vals[gi] = acc
        first_seen = order[starts_g]  # first occurrence (read order) per qname
        ls.expected = _f32_seq_sum(vals[np.argsort(first_seen, kind="stable")])

    # overlap reads (collect.nim:96-116)
    slop = _bounds_slop(b)
    overlap = (np.maximum(start, b.left) <= np.minimum(stop, b.right)) & (
        comp.tid[k] == b.tid
    )
    n_overlap = int(overlap.sum())
    spanning = overlap & (start < (b.left - slop)) & (stop > (b.right + slop))
    span_idx = k[spanning]
    ls.n_spanning_reads = len(span_idx)
    ls.span_rc, ls.span_ind = _spanning_read_rows(comp, span_idx, b,
                                                  with_rc=with_rc)

    # complete pairs -> spanning fragments (collect.nim:36-48,167-179)
    pair_ok = (comp.tid[k] == comp.mate_tid[k]) & (
        np.abs(comp.isize[k]) <= max_size
    )
    pk = k[pair_ok]
    n_frag = 0
    if len(pk):
        q = comp.qid[pk]
        if len(np.unique(q)) > 20_000:  # high-depth abort
            return LocusSupport(med_depth=-1)
        order = np.argsort(q, kind="stable")
        qs = q[order]
        newg = np.empty(len(qs), bool)
        newg[0] = True
        newg[1:] = qs[1:] != qs[:-1]
        starts_g = np.flatnonzero(newg)
        ends_g = np.append(starts_g[1:], len(qs))
        two = np.flatnonzero(ends_g - starts_g == 2)
        if len(two):
            li = pk[order[starts_g[two]]]
            ri = pk[order[starts_g[two] + 1]]
            gate = (comp.pos[li] < (b.left - slop)) & (
                comp.end_pos[ri] > (b.right + slop)
            )
            n_frag = int(gate.sum())
    ls.n_spanning_pairs = n_frag
    ls.n_support = n_overlap + n_frag
    return ls


def iter_components(bounds_list: list[Bounds], window: int):
    """Connected components of overlapping locus windows, sorted by
    (tid, left) — shared structure with collect.spanners_many."""
    items = sorted(
        range(len(bounds_list)),
        key=lambda i: (bounds_list[i].tid, bounds_list[i].left),
    )
    region: list[int] = []
    region_end = -1
    region_tid = -1
    for i in items:
        b = bounds_list[i]
        wl, wr = b.left - window, b.right + window
        if region and b.tid == region_tid and wl <= region_end:
            region.append(i)
            region_end = max(region_end, wr)
        else:
            if region:
                yield region_tid, region
            region = [i]
            region_end = wr
            region_tid = b.tid
    if region:
        yield region_tid, region


def _bind_collect(lib):
    import ctypes as C

    if not hasattr(lib.sio_collect_many, "_bound"):
        P = np.ctypeslib.ndpointer
        lib.sio_collect_many.restype = C.c_int64
        lib.sio_collect_many.argtypes = [
            C.c_void_p, C.c_int64, P(np.int32), P(np.int64), P(np.int64),
            C.c_char_p, C.c_int64, P(np.float32), C.c_int64, C.c_int32,
            C.c_int32, P(np.int32), P(np.int32), P(np.int32), P(np.int32),
            P(np.float32), C.c_int64, P(np.int64), P(np.uint8), P(np.int32),
            C.c_int32, P(np.int64),
        ]
        lib.sio_collect_many._bound = True


def _native_collect_chunk(bam_path, fasta, idxs, bounds_list, window, cd,
                          min_mapq, max_size, with_rc):
    """One thread's contiguous slice of loci through sio_collect_many
    (its own reader handle; the ctypes call releases the GIL)."""
    from strling_tpu_torch.io.bam import Bam, _load

    lib = _load()
    _bind_collect(lib)
    bam = Bam(bam_path, fasta=fasta)
    n = len(idxs)
    ltid = np.array([bounds_list[i].tid for i in idxs], np.int32)
    lleft = np.array([bounds_list[i].left for i in idxs], np.int64)
    lright = np.array([bounds_list[i].right for i in idxs], np.int64)
    lrep = b"".join(
        bounds_list[i].repeat.encode().ljust(8, b"\0") for i in idxs
    )
    n_support = np.zeros(n, np.int32)
    n_span = np.zeros(n, np.int32)
    n_frag = np.zeros(n, np.int32)
    med = np.zeros(n, np.int32)
    expected = np.zeros(n, np.float32)
    n_records = np.zeros(n, np.int64)
    span_cap = max(4096, 64 * n)
    while True:
        span_off = np.zeros(n + 1, np.int64)
        span_rc = np.zeros(span_cap, np.uint8)
        span_ind = np.zeros(span_cap, np.int32)
        rc = lib.sio_collect_many(
            bam._h, n, ltid, lleft, lright, lrep, window, cd, len(cd),
            min_mapq, max_size, n_support, n_span, n_frag, med, expected,
            span_cap, span_off, span_rc, span_ind, 1 if with_rc else 0,
            n_records,
        )
        if rc == -2:
            span_cap *= 4
            continue
        if rc != 0:
            raise OSError("sio_collect_many failed")
        break
    out = {}
    for j, i in enumerate(idxs):
        lo, hi = int(span_off[j]), int(span_off[j + 1])
        out[i] = LocusSupport(
            n_support=int(n_support[j]), n_spanning_reads=int(n_span[j]),
            n_spanning_pairs=int(n_frag[j]),
            span_rc=span_rc[lo:hi].astype(np.int64),
            span_ind=span_ind[lo:hi].astype(np.int64),
            med_depth=int(med[j]), expected=np.float32(expected[j]),
            n_records=int(n_records[j]),
        )
    bam.close()
    return out


def collect_many_native(bam, bounds_list: list[Bounds], window: int,
                        frag_sizes: np.ndarray, min_mapq: int = 20,
                        max_size: int = 5000, threads: int = 2,
                        with_rc: bool = False) -> dict[int, LocusSupport] | None:
    """The per-locus collection loop in native code (csrc/collect_native.cc):
    one BAI region query per locus, loci sharded across reader threads.
    Returns None when the native library is unavailable (caller falls back
    to the vectorized Python twin)."""
    try:
        from strling_tpu_torch.io.bam import _load

        _bind_collect(_load())
    except Exception:
        return None
    if not bounds_list:
        return {}
    order = sorted(
        range(len(bounds_list)),
        key=lambda i: (bounds_list[i].tid, bounds_list[i].left),
    )
    cd = np.ascontiguousarray(cumulative(frag_sizes), np.float32)
    T = max(1, min(threads, len(order)))
    chunks = [
        order[k * len(order) // T : (k + 1) * len(order) // T]
        for k in range(T)
    ]
    chunks = [c for c in chunks if c]
    results: dict[int, LocusSupport] = {}
    if len(chunks) == 1:
        results.update(_native_collect_chunk(
            bam.path, bam.fasta, chunks[0], bounds_list, window, cd,
            min_mapq, max_size, with_rc))
        return results
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(chunks)) as ex:
        futs = [
            ex.submit(_native_collect_chunk, bam.path, bam.fasta, c,
                      bounds_list, window, cd, min_mapq, max_size, with_rc)
            for c in chunks
        ]
        for f in futs:
            results.update(f.result())
    return results


#: merge nearby components into one streaming query when the gap between
#: their windows is below this — random-access re-seeks decode overlapping
#: BGZF blocks repeatedly, so for dense loci one sequential pass is much
#: cheaper. Per-locus results are unchanged (membership is masked inside).
JOIN_GAP = 20_000

#: bound one super-region's span so the cached read stream stays modest
MAX_SUPER_SPAN = 8_000_000


def _iter_super_regions(bounds_list: list[Bounds], window: int):
    """Group components into super-regions: adjacent windows on one tid
    joined while the gap stays under JOIN_GAP and the span under
    MAX_SUPER_SPAN."""
    super_tid = -1
    super_idx: list[int] = []
    super_lo = super_hi = -1
    for tid, region in iter_components(bounds_list, window):
        rl = max(0, min(bounds_list[i].left for i in region) - window)
        rr = max(bounds_list[i].right + window for i in region)
        if (
            super_idx
            and tid == super_tid
            and rl - super_hi <= JOIN_GAP
            and rr - super_lo <= MAX_SUPER_SPAN
        ):
            super_idx.extend(region)
            super_hi = max(super_hi, rr)
        else:
            if super_idx:
                yield super_tid, super_idx, super_lo, super_hi
            super_tid, super_idx, super_lo, super_hi = tid, list(region), rl, rr
    if super_idx:
        yield super_tid, super_idx, super_lo, super_hi


def collect_many(bam, bounds_list: list[Bounds], window: int,
                 frag_sizes: np.ndarray, min_mapq: int = 20,
                 max_size: int = 5000,
                 with_rc: bool = False) -> dict[int, LocusSupport]:
    """Batched replacement for collect.spanners_many on the non-debug call
    path: one streaming BAM pass per super-region of nearby locus windows,
    all per-locus quantities computed vectorized. Result fields are
    bit-identical to the per-record spec (equivalence-tested)."""
    cd = cumulative(frag_sizes)
    results: dict[int, LocusSupport] = {}
    for tid, region, rl, rr in _iter_super_regions(bounds_list, window):
        _collect_region(bam, bounds_list, tid, region, rl, rr, window, cd,
                        frag_sizes, min_mapq, max_size, results,
                        with_rc=with_rc)
    return results


#: buffered reads per processing chunk in the streaming pass
CHUNK_READS = 131_072


def _collect_region(bam, bounds_list, tid, region, rl, rr, window, cd,
                    frag_sizes, min_mapq, max_size, results,
                    with_rc=False):
    """ONE streaming pass over the region: buffer batches, and whenever the
    buffer is full process every locus whose window lies entirely behind the
    stream frontier (pos-sorted stream: no future read can be a member).
    Batches that can no longer matter for the remaining loci are dropped,
    so memory stays ~CHUNK_READS regardless of region size. Per-locus
    results are partition-independent (membership is masked inside)."""
    rem = list(region)  # sorted by left (iter_components order)
    buf: list = []
    nbuf = 0

    def process(frontier):
        nonlocal rem, buf, nbuf
        take = [i for i in rem if bounds_list[i].right + window <= frontier]
        if not take:
            return
        taken = set(take)
        rem = [i for i in rem if i not in taken]
        # union of the chunk's windows as merged disjoint intervals — reads
        # in the gaps between windows are never copied into the component.
        # Also pre-apply the locus-independent keep filter (flags + mapq):
        # every downstream quantity uses kept reads only.
        ivs = sorted(
            (max(0, bounds_list[i].left - window),
             bounds_list[i].right + window)
            for i in take
        )
        mstarts, mends = [ivs[0][0]], [ivs[0][1]]
        for s, e in ivs[1:]:
            if s <= mends[-1]:
                mends[-1] = max(mends[-1], e)
            else:
                mstarts.append(s)
                mends.append(e)
        mstarts = np.array(mstarts, np.int64)
        mends = np.array(mends, np.int64)
        masks = []
        for b in buf:
            p = b.pos.astype(np.int64)
            e = b.end_pos.astype(np.int64)
            stab = np.searchsorted(mstarts, e, side="left") > np.searchsorted(
                mends, p, side="right"
            )
            keep = ((b.flag.astype(np.int64) & _SKIP_FLAGS) == 0) & (
                b.mapq >= min_mapq
            )
            masks.append(stab & keep)
        comp = _Component(buf, masks)
        for i in take:
            results[i] = _collect_one(comp, bounds_list[i], window, cd,
                                      frag_sizes, min_mapq, max_size,
                                      with_rc=with_rc)
        if rem:
            next_wl = min(max(0, bounds_list[i].left - window) for i in rem)
            buf = [
                b for b in buf
                if len(b) and int(b.end_pos.max()) > next_wl
            ]
        else:
            buf = []
        nbuf = sum(len(b) for b in buf)

    for batch in bam.query(tid, rl, rr):
        buf.append(batch)
        nbuf += len(batch)
        if nbuf >= CHUNK_READS and len(batch):
            process(int(batch.pos[-1]))
    process(float("inf"))
