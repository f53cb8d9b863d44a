"""The generator of whole-genome paired-end reads for a `wgs` deployment.

`make(config, traffic, seed, out_dir)` writes, from the seed alone:
- `ref.fa` (+ `.fai`): the genome share, synthetic, with STR loci planted at
  the density and unit mix the configuration states, and the reference
  alleles of the expanded loci it lists;
- `ref.fa.str`: the benchmark's own `.str` index of it (`strindex`);
- `sample.bam` (+ `.bai`): a coordinate-sorted, indexed BAM of the sample at
  the configuration's coverage, with the read layout the traffic file states;
- `warm.bam` (+ `.bai`): a few hundred thousand of the same traffic's
  records (`warm_records`), which set-up runs a pass over.

Every number comes from the two JSON files: the configuration (genome,
contigs, STR loci, expanded alleles, coverage) and the traffic (read length,
insert size, and the shares of errors, Ns, clips, indels, duplicates, MAPQ-0
pairs, discordant pairs, unmapped mates and unmapped pairs). Reads of the
expanded alleles follow what an aligner does with them: flank reads are
soft-clipped where the expansion leaves the reference, reads inside it map
with MAPQ 0 to another locus of the same unit or stay unmapped.

The layout of the sample (positions, classes) is drawn first for the whole
file; bases, errors and qualities are then drawn a chunk of records at a
time from generators seeded by (seed, chunk), so the file is the same for
one seed whatever the number of threads.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import time

import numpy as np

from portbench.gen.bamio import BgzfFile, assemble, cigar_strings, deflate_blocks

ACGT = np.frombuffer(b"ACGT", np.uint8)
M, I, D, S = 0, 1, 2, 4
CHUNK = 1 << 18
WARM_SHARE = 0.03   # the share of the genome whose pairs go into the warm BAM


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), *salt])


def _random_bases(rng, n: int, gc: float) -> np.ndarray:
    cum = np.cumsum([(1 - gc) / 2, gc / 2, gc / 2])
    return ACGT[np.searchsorted(cum, rng.random(n, dtype=np.float32))]


def _primitive(unit: bytes) -> bool:
    k = len(unit)
    return not any(k % d == 0 and unit == unit[:d] * (k // d)
                   for d in range(1, k))


def _draw_unit(rng, k: int, weights: dict) -> bytes:
    table = weights.get(str(k))
    if table:
        units = list(table)
        p = np.array([table[u] for u in units], np.float64)
        return units[rng.choice(len(units), p=p / p.sum())].encode()
    while True:
        u = bytes(ACGT[rng.integers(0, 4, k)])
        if _primitive(u):
            return u


def make_genome(cfg: dict, seed: int):
    """(sequence as ASCII bytes, planted loci [(start, stop, unit)],
    expansions [(start, stop, unit, copies)]) of the share."""
    g = cfg["genome"]
    rng = _rng(seed, 1)
    n = int(g["length"])
    seq = _random_bases(rng, n, g["gc"])
    st = g["str_loci"]
    ks = np.array(sorted(st["unit_mix"], key=int), np.int64)
    pk = np.array([st["unit_mix"][str(k)] for k in ks], np.float64)
    mean_bp = st["min_bp"] + st["mean_extra_bp"]
    n_loci = int(st["fraction"] * n / mean_bp)
    starts = np.sort(rng.integers(0, n - 400, n_loci))
    kk = ks[rng.choice(len(ks), n_loci, p=pk / pk.sum())]
    bp = st["min_bp"] + rng.exponential(st["mean_extra_bp"], n_loci)
    copies = np.maximum(np.ceil(bp / kk), st.get("min_copies", 3)).astype(np.int64)
    loci = []
    last_end = -1
    exp_spans = [(e["share_pos"] - 2000, e["share_pos"] + 2000)
                 for e in cfg.get("expansions", [])]
    for s, k, c in zip(starts.tolist(), kk.tolist(), copies.tolist()):
        if s < last_end + 20 or any(a <= s <= b for a, b in exp_spans):
            continue
        u = _draw_unit(rng, k, st.get("unit_weights", {}))
        e = s + k * c
        seq[s:e] = np.frombuffer(u * c, np.uint8)
        loci.append((s, e, u))
        last_end = e
    expansions = []
    for x in cfg.get("expansions", []):
        u = x["unit"].encode()
        s = int(x["share_pos"])
        e = s + len(u) * int(x["ref_copies"])
        seq[s:e] = np.frombuffer(u * int(x["ref_copies"]), np.uint8)
        expansions.append((s, e, u, int(x["copies"])))
    return seq, loci, expansions


def make_layout(cfg: dict, tr: dict, seq: np.ndarray, loci, expansions,
                seed: int):
    """Every record's placement, class and CIGAR (bases come later)."""
    rng = _rng(seed, 2)
    G = len(seq)
    L = int(tr["read_length"])
    tid0 = cfg["share_tid"]
    n_pairs = int(round(cfg["coverage"] * G / (2 * L)))
    frag = np.rint(rng.normal(tr["insert_mean"], tr["insert_sd"], n_pairs))
    frag = np.clip(frag, L, tr["insert_mean"] + 6 * tr["insert_sd"]).astype(np.int64)
    start = rng.integers(0, G - frag)
    # duplicates: copies of other fragments, flagged on the copy
    dup = rng.random(n_pairs) < tr["duplicate_share"]
    src_pair = rng.integers(0, n_pairs, n_pairs)
    start = np.where(dup, start[src_pair], start)
    frag = np.where(dup, frag[src_pair], frag)
    r1_left = rng.random(n_pairs) < 0.5
    u = rng.random(n_pairs)
    sh = np.cumsum([tr["discordant_share"], tr["mate_unmapped_share"],
                    tr["unmapped_pair_share"]])
    cls = np.searchsorted(sh, u, side="right")  # 0 disc, 1 mate unmapped, 2 unmapped pair, 3 normal
    q = rng.random(n_pairs)
    pair_mapq = np.where(q < tr["mapq0_share"], 0,
                         np.where(q < tr["mapq0_share"] + tr["low_mapq_share"],
                                  rng.integers(1, 60, n_pairs), 60))

    # the left mate of each fragment, then the right one
    a = {"pair": np.tile(np.arange(n_pairs), 2),
         "rno": np.concatenate([np.where(r1_left, 0, 1), np.where(r1_left, 1, 0)]),
         "tid": np.full(2 * n_pairs, tid0, np.int64),
         "pos": np.concatenate([start, start + frag - L]),
         "mapq": np.tile(pair_mapq, 2),
         "rev": np.repeat([False, True], n_pairs),
         "mapped": np.ones(2 * n_pairs, bool),
         "ncig": np.ones(2 * n_pairs, np.int64),
         "ops": np.zeros((2 * n_pairs, 3), np.uint8),
         "lens": np.zeros((2 * n_pairs, 3), np.int64)}
    a["end"] = a["pos"] + L
    a["src"] = a["pos"].copy()
    a["lens"][:, 0] = L
    N = len(a["pos"])
    pcls = np.concatenate([cls, cls])
    side = np.concatenate([np.zeros(n_pairs, bool), np.ones(n_pairs, bool)])

    # discordant pairs: one mate on another primary contig, random bases
    mv_side = rng.random(n_pairs) < 0.5
    moved = (pcls == 0) & (side == np.concatenate([mv_side, mv_side]))
    others = [(t, ln) for t, (nm, ln) in enumerate(cfg["contigs"]) if t != tid0
              and ln > 10 * L]
    w = np.array([ln for _, ln in others], np.float64)
    pick = rng.choice(len(others), N, p=w / w.sum())
    otid = np.array([t for t, _ in others])[pick]
    olen = np.array([ln for _, ln in others])[pick]
    opos = (rng.random(N) * (olen - L)).astype(np.int64)
    a["tid"] = np.where(moved, otid, a["tid"])
    a["pos"] = np.where(moved, opos, a["pos"])
    a["end"] = np.where(moved, opos + L, a["end"])
    a["mapq"] = np.where(moved, rng.integers(0, 61, N), a["mapq"])
    a["src"] = np.where(moved, -1, a["src"])
    # one mate unmapped: placed at its mate's position
    unm = (pcls == 1) & side
    a["mapped"] = np.where(unm | (pcls == 2), False, a["mapped"])
    a["src"] = np.where(unm | (pcls == 2), -1, a["src"])

    mapped_plain = a["mapped"] & (a["src"] >= 0)
    # soft clips of adapter or low-quality ends, and small indels
    v = rng.random(N)
    clip = mapped_plain & (v < tr["clip_share"])
    indel = mapped_plain & ~clip & (v > 1 - tr["indel_share"])
    x = rng.integers(tr["clip_min"], tr["clip_max"] + 1, N)
    at_3p = a["rev"]  # the 3' end of a reverse read is on the left
    # left clip: xS (L-x)M, the aligned start moves right
    lc = clip & at_3p
    rc = clip & ~at_3p
    a["ncig"] = np.where(clip, 2, a["ncig"])
    a["ops"][lc] = [S, M, 0]
    a["lens"][lc] = np.stack([x[lc], L - x[lc], np.zeros(lc.sum(), np.int64)], 1)
    a["pos"] = np.where(lc, a["pos"] + x, a["pos"])
    a["src"] = np.where(lc, a["pos"], a["src"])
    a["ops"][rc] = [M, S, 0]
    a["lens"][rc] = np.stack([L - x[rc], x[rc], np.zeros(rc.sum(), np.int64)], 1)
    a["end"] = np.where(clip, a["pos"] + L - x, a["end"])
    b = rng.integers(1, 4, N)
    off = rng.integers(20, L - 23, N)
    ins = indel & (rng.random(N) < 0.5)
    dele = indel & ~ins
    a["ncig"] = np.where(indel, 3, a["ncig"])
    a["ops"][ins] = [M, I, M]
    a["lens"][ins] = np.stack([off[ins], b[ins], L - off[ins] - b[ins]], 1)
    a["ops"][dele] = [M, D, M]
    a["lens"][dele] = np.stack([off[dele], b[dele], L - off[dele]], 1)
    a["end"] = np.where(ins, a["pos"] + L - b, np.where(dele, a["pos"] + L + b,
                                                        a["end"]))
    a["special_kind"] = np.where(clip, 1, np.where(indel, 2, 0))
    a["clip_x"] = np.where(clip, x, 0)
    a["indel_at"] = np.where(indel, off, 0)
    a["indel_b"] = np.where(indel, b, 0)
    a["cls"] = pcls
    a["dup"] = np.concatenate([dup, dup])
    a["side"] = side
    a["exp_seq"] = np.full(N, -1, np.int64)
    n_pairs_total = n_pairs
    exp_seqs: list[bytes] = []
    extra = _expansion_pairs(cfg, tr, seq, loci, expansions, rng, n_pairs_total,
                             exp_seqs)
    if extra is not None:
        for k in a:
            a[k] = np.concatenate([a[k], extra[k]])
        n_pairs_total += len(extra["pos"]) // 2
    a["unmapped_pair"] = a["cls"] == 2
    a["exp_table"] = exp_seqs
    a["n_pairs"] = n_pairs_total
    return a


def _expansion_pairs(cfg, tr, seq, loci, expansions, rng, pid0, exp_seqs):
    """Pairs drawn from the expanded haplotype of each expanded locus, at
    half the coverage (one allele)."""
    if not expansions:
        return None
    L = int(tr["read_length"])
    tid0 = cfg["share_tid"]
    by_unit: dict[bytes, list[int]] = {}
    for s, e, u in loci:
        by_unit.setdefault(u, []).append(s)
    rows = []
    for ls, le, unit, copies in expansions:
        k = len(unit)
        E = k * copies
        hap = np.concatenate([seq[max(0, ls - 3000):ls],
                              np.frombuffer(unit * copies, np.uint8),
                              seq[le:le + 3000]])
        h0 = max(0, ls - 3000)       # reference coordinate of hap[0]
        rep_s = ls - h0              # repeat start in hap
        rep_e = rep_s + E
        ref_rep = le - ls
        region = (rep_s - 1500, rep_e + 1500)
        n = int(cfg["coverage"] / 2 * (region[1] - region[0]) / (2 * L))
        frag = np.clip(np.rint(rng.normal(tr["insert_mean"], tr["insert_sd"], n)),
                       L, tr["insert_mean"] + 6 * tr["insert_sd"]).astype(np.int64)
        hs = rng.integers(region[0], region[1] - frag)
        for j in range(n):
            reads = []
            for hpos, rev in ((int(hs[j]), False), (int(hs[j] + frag[j] - L), True)):
                b = bytes(hap[hpos:hpos + L])
                if hpos + L <= rep_s:            # left flank
                    reads.append(("map", h0 + hpos, [(M, L)], 60, b, rev))
                elif hpos >= rep_e:              # right flank
                    reads.append(("map", h0 + hpos - E + ref_rep, [(M, L)], 60, b, rev))
                elif hpos >= rep_s and hpos + L <= rep_e:   # inside
                    alt = by_unit.get(unit)
                    if alt and rng.random() < 0.5:
                        p = alt[int(rng.integers(0, len(alt)))]
                        reads.append(("map", p, [(M, 40), (S, L - 40)], 0, b, rev))
                    else:
                        reads.append(("unmapped", None, [], 0, b, rev))
                elif hpos < rep_s:               # left flank into the repeat
                    m = min(L, rep_s - hpos + ref_rep)
                    cig = [(M, m)] + ([(S, L - m)] if m < L else [])
                    reads.append(("map", h0 + hpos, cig, 60, b, rev))
                else:                            # repeat into the right flank
                    flank = hpos + L - rep_e
                    m = min(L, flank + ref_rep)
                    cig = ([(S, L - m)] if m < L else []) + [(M, m)]
                    reads.append(("map", le - (m - flank), cig, 60, b, rev))
            rows.append(reads)
    N = 2 * len(rows)
    out = {
        "pair": np.repeat(np.arange(pid0, pid0 + len(rows)), 2),
        "rno": np.tile([0, 1], len(rows)),
        "tid": np.full(N, tid0, np.int64), "pos": np.zeros(N, np.int64),
        "end": np.zeros(N, np.int64), "mapq": np.zeros(N, np.int64),
        "rev": np.tile([False, True], len(rows)), "mapped": np.ones(N, bool),
        "ncig": np.zeros(N, np.int64), "src": np.full(N, -1, np.int64),
        "ops": np.zeros((N, 3), np.uint8),
        "lens": np.zeros((N, 3), np.int64), "special_kind": np.zeros(N, np.int64),
        "clip_x": np.zeros(N, np.int64), "indel_at": np.zeros(N, np.int64),
        "indel_b": np.zeros(N, np.int64), "cls": np.full(N, 3, np.int64),
        "dup": np.zeros(N, bool), "side": np.tile([False, True], len(rows)),
        "exp_seq": np.zeros(N, np.int64),
    }
    for j, reads in enumerate(rows):
        unmapped = [r[0] == "unmapped" for r in reads]
        for s, (kind, pos, cig, mq, b, rev) in enumerate(reads):
            i = 2 * j + s
            out["exp_seq"][i] = len(exp_seqs)
            exp_seqs.append(b)
            if kind == "unmapped":
                out["mapped"][i] = False
                continue
            out["pos"][i] = pos
            out["mapq"][i] = mq
            out["ncig"][i] = len(cig)
            for c, (op, ln) in enumerate(cig):
                out["ops"][i, c] = op
                out["lens"][i, c] = ln
            out["end"][i] = pos + sum(ln for op, ln in cig if op in (M, D))
        if all(unmapped):
            out["cls"][2 * j:2 * j + 2] = 2
        elif any(unmapped):
            out["cls"][2 * j:2 * j + 2] = 1
    return out


def finish_layout(a: dict, cfg: dict, L: int):
    """Mate fields, flags, TLEN and the file order."""
    N = len(a["pos"])
    pair, rno = a["pair"], a["rno"]
    order_pair = np.lexsort((a["side"], pair))   # mates next to each other
    mate = np.empty(N, np.int64)
    mate[order_pair[0::2]] = order_pair[1::2]
    mate[order_pair[1::2]] = order_pair[0::2]
    mapped = a["mapped"]
    both_unmapped = ~mapped & ~mapped[mate]
    # an unmapped read sits at its mate's place; a pair of them nowhere
    a["tid"] = np.where(~mapped, np.where(both_unmapped, -1, a["tid"][mate]), a["tid"])
    a["pos"] = np.where(~mapped, np.where(both_unmapped, -1, a["pos"][mate]), a["pos"])
    a["end"] = np.where(~mapped, a["pos"] + 1, a["end"])
    a["mapq"] = np.where(mapped, a["mapq"], 0)
    a["ncig"] = np.where(mapped, a["ncig"], 0)
    mtid, mpos = a["tid"][mate], a["pos"][mate]
    same = (a["tid"] == mtid) & mapped & mapped[mate]
    left = np.minimum(a["pos"], mpos)
    right = np.maximum(a["end"], a["end"][mate])
    span = right - left
    first = (a["pos"] < mpos) | ((a["pos"] == mpos) & (rno == 0))
    tlen = np.where(same, np.where(first, span, -span), 0)
    proper = same & (a["cls"] == 3) & (span < 2000) & (a["rev"] != a["rev"][mate])
    flag = (0x1 | np.where(proper, 0x2, 0) | np.where(~mapped, 0x4, 0)
            | np.where(~mapped[mate], 0x8, 0)
            | np.where(mapped & a["rev"], 0x10, 0)
            | np.where(mapped[mate] & a["rev"][mate], 0x20, 0)
            | np.where(rno == 0, 0x40, 0x80) | np.where(a["dup"], 0x400, 0))
    a["flag"] = flag.astype(np.int64)
    a["mtid"], a["mpos"], a["tlen"] = mtid, mpos, tlen
    a["mate"] = mate
    key_tid = np.where(a["tid"] < 0, 1 << 30, a["tid"])
    order = np.lexsort((rno, pair, a["pos"], key_tid))
    return order


def _names(pair_ids: np.ndarray, rng_seed: int, n_pairs: int) -> np.ndarray:
    """Illumina-style read names, fixed width, from a random code per pair."""
    code = (pair_ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
            + np.uint64(rng_seed % (1 << 63))) % np.uint64(1 << 40)
    code = code.astype(np.int64)
    tile = 1101 + (code % 1000)
    x = (code // 1000) % 100000
    y = (code // 100000000) % 100000
    prefix = np.frombuffer(b"A00737:412:HGJ7LDSXY:2:", np.uint8)
    n = len(pair_ids)
    out = np.zeros((n, len(prefix) + 4 + 1 + 5 + 1 + 5 + 1), np.uint8)
    out[:, :len(prefix)] = prefix
    col = len(prefix)
    for val, width, sep in ((tile, 4, b":"), (x, 5, b":"), (y, 5, b"")):
        for d in range(width):
            out[:, col + d] = 48 + (val // 10 ** (width - 1 - d)) % 10
        col += width
        if sep:
            out[:, col] = sep[0]
            col += 1
    # pair ids above the code space get the pair number in the y field's place
    return out


_G: dict = {}


def _init_worker(shared: dict):
    _G.update(shared)


CHUNK_COLS = ("src", "special_kind", "clip_x", "indel_at", "indel_b",
              "exp_seq", "mapped", "pair", "tid", "pos", "end", "mapq", "flag",
              "mtid", "mpos", "tlen", "ncig", "ops", "lens")


def _chunk(job):
    """Bases, errors and qualities of one chunk of records, its BAM bytes
    cut into BGZF blocks: (blocks, record offsets, tid, start, end)."""
    ci, c, mate_cols = job
    g = _G
    tr, L, seed = g["tr"], g["L"], g["seed"]
    gpad = g["gpad"]
    col = np.arange(L)[None, :]
    n = len(c["src"])
    rng = _rng(seed, 3, ci)
    src = c["src"]
    plain = src >= 0
    kind = c["special_kind"]
    gview = np.lib.stride_tricks.sliding_window_view(gpad, L)
    bases = gview[np.where(plain, src, 0)].copy()
    sp = np.flatnonzero(~plain | (kind > 0))
    junk = _random_bases(rng, len(sp) * L, 0.41).reshape(len(sp), L)
    op0, op1 = c["ops"][sp, 0], c["ops"][sp, 1]
    k, x, p, q = kind[sp], c["clip_x"][sp], c["indel_at"][sp], c["indel_b"][sp]
    s_ = np.where(plain[sp], src[sp], 0)[:, None]
    out = bases[sp]
    lc = (k == 1) & (op0 == S)
    rc = (k == 1) & (op0 == M)
    ins = (k == 2) & (op1 == I)
    dele = (k == 2) & (op1 == D)
    out = np.where(~plain[sp][:, None], junk, out)
    out = np.where(lc[:, None], np.where(col < x[:, None], junk,
                                         gpad[(s_ + col - x[:, None]).clip(0)]), out)
    out = np.where(rc[:, None] & (col >= (L - x)[:, None]), junk, out)
    out = np.where(ins[:, None] & (col >= p[:, None]) & (col < (p + q)[:, None]),
                   junk, out)
    out = np.where(ins[:, None] & (col >= (p + q)[:, None]),
                   gpad[(s_ + col - q[:, None]).clip(0)], out)
    out = np.where(dele[:, None] & (col >= p[:, None]),
                   gpad[s_ + col + q[:, None]], out)
    bases[sp] = out
    for r in np.flatnonzero(c["exp_seq"] >= 0):
        bases[r] = np.frombuffer(g["exp_table"][c["exp_seq"][r]], np.uint8)
    # sequencing errors and no-calls, drawn sparsely
    flat = bases.reshape(-1)
    n_err = rng.binomial(n * L, tr["error_rate"])
    epos = rng.integers(0, n * L, n_err)
    flat[epos] = ACGT[(g["code_of"][flat[epos]] + rng.integers(1, 4, n_err)) % 4]
    n_nc = rng.binomial(n * L, tr["n_rate"])
    npos = rng.integers(0, n * L, n_nc)
    flat[npos] = ord("N")
    qual = g["qlut"][np.frombuffer(rng.bytes(n * L), np.uint8)].reshape(n, L)
    qflat = qual.reshape(-1)
    qflat[epos] = tr["error_qual"]
    qflat[npos] = 2
    err_row = np.bincount(epos // L, minlength=n)
    mapped = c["mapped"]
    nm = np.where(mapped, np.minimum(err_row + np.where(kind == 2, c["indel_b"], 0),
                                     255), 0)
    cc = {key: c[key] for key in ("tid", "pos", "end", "mapq", "flag", "mtid",
                                  "mpos", "tlen", "ncig", "ops", "lens")}
    cc["mq"], cc["mate_mapped"], mc_idx = mate_cols
    cc["nm"] = nm
    clipped = np.where(kind == 1, c["clip_x"], 0)
    cc["as_"] = np.where(mapped, np.clip(L - 5 * nm - clipped, 0, 255), 0)
    cc["mapped"] = mapped
    names = _names(c["pair"], seed, g["n_pairs"])
    data, starts = assemble(cc, bases, qual, names, mc_idx, g["cig_table"],
                            g["rg"])
    return (deflate_blocks(data, g["level"]), starts, c["tid"], c["pos"],
            np.maximum(c["end"], c["pos"] + 1))


def write_sample(files: list, cfg: dict, tr: dict, seq: np.ndarray, a: dict,
                 seed: int, level: int, workers: int) -> int:
    """A BAM and its BAI for each (path, records in file order) of `files`,
    chunks made by `workers` processes in turn."""
    L = int(tr["read_length"])
    contigs = cfg["contigs"]
    header = ("@HD\tVN:1.6\tSO:coordinate\n"
              + "".join(f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in contigs)
              + f"@RG\tID:{cfg['read_group']}\tSM:{cfg['sample']}\tPL:ILLUMINA"
              f"\tLB:{cfg['sample']}-lib1\n"
              + "@PG\tID:bwa\tPN:bwa\tVN:0.7.17-r1188\n")
    cig_idx, cig_table = cigar_strings(a["ncig"], a["ops"], a["lens"])
    qv = np.array(tr["qual_values"], np.uint8)
    qp = np.array(tr["qual_shares"], np.float64)
    qcum = np.cumsum(qp / qp.sum())[:-1]
    code_of = np.zeros(256, np.uint8)
    code_of[ACGT] = np.arange(4)
    shared = {"tr": tr, "L": L, "seed": seed, "level": level,
              "gpad": np.concatenate([seq, np.zeros(L + 8, np.uint8)]),
              "exp_table": a["exp_table"], "code_of": code_of,
              "qlut": qv[np.searchsorted(qcum, (np.arange(256) + 0.5) / 256)],
              "cig_table": cig_table, "rg": cfg["read_group"].encode(),
              "n_pairs": a["n_pairs"]}
    mate = a["mate"]

    def jobs(order):
        for ci, s0 in enumerate(range(0, len(order), CHUNK)):
            idx = order[s0:s0 + CHUNK]
            c = {k: a[k][idx] for k in CHUNK_COLS}
            yield ci, c, (a["mapq"][mate[idx]], a["mapped"][mate[idx]],
                          cig_idx[mate[idx]])

    def write(mapper) -> int:
        written = 0
        for path, order in files:
            out = BgzfFile(path, header, [(n, ln) for n, ln in contigs], level)
            for r in mapper(_chunk, jobs(order)):
                out.add(*r)
            written += out.close()
        return written

    if workers <= 1:
        _init_worker(shared)
        return write(map)
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers, initializer=_init_worker,
                  initargs=(shared,)) as pool:
        return write(pool.imap)


def warm_records(a: dict, cfg: dict) -> np.ndarray:
    """Which records go into the warm-up BAM: each pair with a read placed
    in the first `WARM_SHARE` of the share's bases or within 20 kb of an
    expanded locus, each pair with a read of an expanded allele, and the first 2,000
    records of unmapped pairs. A few hundred thousand records of the same
    traffic, so that set-up loads and warms what a pass runs."""
    on = a["tid"] == cfg["share_tid"]
    sel = on & (a["pos"] < WARM_SHARE * cfg["genome"]["length"])
    for e in cfg.get("expansions", []):
        sel |= on & (np.abs(a["pos"] - int(e["share_pos"])) < 20_000)
    sel |= a["exp_seq"] >= 0
    sel[np.flatnonzero(a["tid"] < 0)[:2000]] = True
    return sel | sel[a["mate"]]


def write_fasta(path: str, name: str, seq: np.ndarray) -> int:
    n = len(seq)
    lines = 60
    body = np.full(n + (n + lines - 1) // lines, ord("\n"), np.uint8)
    idx = np.arange(n)
    body[idx + idx // lines] = seq
    head = f">{name}\n".encode()
    with open(path, "wb") as fh:
        fh.write(head)
        fh.write(body.tobytes())
    with open(path + ".fai", "w") as fh:
        fh.write(f"{name}\t{n}\t{len(head)}\t{lines}\t{lines + 1}\n")
    return len(head) + len(body)


def make(cfg: dict, tr: dict, seed: int, out_dir: str, workers: int | None = None,
         device: str | None = None) -> dict:
    """Write the inputs of one seed into `out_dir`; returns the manifest."""
    import torch

    from portbench.gen import strindex

    t0 = time.perf_counter()
    workers = workers or min(8, os.cpu_count() or 1)
    os.makedirs(out_dir, exist_ok=True)
    seq, loci, expansions = make_genome(cfg, seed)
    share = cfg["contigs"][cfg["share_tid"]][0]
    fa = os.path.join(out_dir, "ref.fa")
    written = write_fasta(fa, share, seq)
    dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    n_str = strindex.write_index(fa + ".str", [(share, seq)], dev)
    a = make_layout(cfg, tr, seq, loci, expansions, seed)
    order = finish_layout(a, cfg, int(tr["read_length"]))
    bam = os.path.join(out_dir, "sample.bam")
    warm = os.path.join(out_dir, "warm.bam")
    order_warm = order[warm_records(a, cfg)[order]]
    written += write_sample([(bam, order), (warm, order_warm)], cfg, tr, seq,
                            a, seed, int(tr.get("bgzf_level", 6)), workers)
    n = len(order)
    manifest = {
        "seed": seed, "fasta": fa, "str": fa + ".str", "bam": bam,
        "warm_bam": warm, "n_warm_records": int(len(order_warm)),
        "n_records": int(n), "n_pairs": int(a["n_pairs"]),
        "n_str_regions": n_str, "n_planted_loci": len(loci),
        "bytes_written": int(written + os.path.getsize(fa + ".str")),
        "gen_s": time.perf_counter() - t0,
        "shares": {
            "duplicate": float(a["dup"].mean()),
            "mapq0": float((a["mapq"][a["mapped"]] == 0).mean()),
            "unmapped": float((~a["mapped"]).mean()),
            "discordant": float(((a["tid"] != a["mtid"]) & a["mapped"]
                                 & a["mapped"][a["mate"]]).mean()),
            "soft_clipped": float((a["ops"][:, :3] == S).any(axis=1).mean()),
            "indel": float(((a["ops"] == I) | (a["ops"] == D)).any(axis=1).mean()),
            "expanded_allele_reads": int((a["exp_seq"] >= 0).sum()),
        },
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
    return manifest
