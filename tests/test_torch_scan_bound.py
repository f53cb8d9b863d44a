"""The repeat scan's bound (`exp_kernel_timing.scan_bound`) counts the
operations of the k that the selection state machine reads, as the plain
detector reports them (`ops.kmer.selection_path_plain`), held here to an
independent walk of the oracle's loop and to counts done by hand."""

import numpy as np
import pytest
import torch

from strling_tpu_torch.ops import kmer as TK
from strling_tpu_torch.ops import kmer_cuda, oracle
from strling_tpu_torch.ops.encode import decode_kmer
from strling_tpu_torch.scripts import exp_kernel_timing as T

torch.set_num_threads(1)


def _oracle_path(read: str, p: float):
    """get_repeat's loop (ops/oracle.py), recording which k's modal count
    and which k's exact count it reads."""
    reached, recounted = [False] * 5, [False] * 5
    if read.count("N") > 20:
        return reached, recounted, True
    best = -1
    L = len(read)
    for ki, k in enumerate(range(2, 7)):
        reached[ki] = True
        imax, count = oracle.modal_window_code(read, k)
        s = decode_kmer(imax if imax >= 0 else (1 << (2 * k)) - 1, k)
        if count * k <= best:
            if count < int(L * 0.12 / k):
                break
            continue
        recounted[ki] = True
        count = read.count(s)
        if count * k < best:
            continue
        best = count * k
    return reached, recounted, False


def _reads(seed, n, L, with_n):
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGTN" if with_n else "ACGT"))
    units = ["AT", "CAG", "AAGGG", "GGGGCC", "A", "ATTCT"]
    reads = []
    for i in range(n):
        ln = int(rng.integers(1, L + 1))
        if i % 3 == 0:
            r = "".join(alpha[rng.integers(0, len(alpha), ln)])
        else:
            u = units[i % len(units)]
            s = list((u * (ln // len(u) + 2))[:ln])
            for _ in range(int(rng.integers(0, max(1, ln // 10)))):
                s[rng.integers(0, ln)] = alpha[rng.integers(0, len(alpha))]
            r = "".join(s)
        reads.append(r)
    if with_n:
        reads[1] = "N" * 21 + reads[1][21:] if len(reads[1]) > 21 else "N" * 30
    bases = np.zeros((n, L), np.uint8)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    props = rng.choice([0.8, 0.6, 0.4], n)
    return reads, bases, lengths, props


def _entry(layout, bases, lengths, props):
    """(x, named) CPU tensors of `layout` for these reads."""
    if layout in ("n8", "w8", "w16"):
        payload, got = TK.fuse_payload(bases, lengths, props,
                                       return_layout=True)
        assert got == layout
        return torch.from_numpy(payload), {}
    te, tp = TK._host_thresholds(lengths, props)
    named = {"lengths": lengths, "te": te, "tp": tp}
    x = bases
    if layout == "packed":
        x, named["nbits"] = TK.pack_bases(bases)
    return torch.from_numpy(x), {k: torch.from_numpy(v)
                                 for k, v in named.items()}


@pytest.mark.parametrize("layout,L,with_n", [("n8", 152, False),
                                             ("w8", 152, True),
                                             ("w16", 256, True),
                                             ("ascii", 152, True),
                                             ("packed", 152, True)])
def test_selection_path_matches_oracle_walk(layout, L, with_n):
    reads, bases, lengths, props = _reads(L + with_n, 300, L, with_n)
    x, named = _entry(layout, bases, lengths, props)
    reached, recounted, skip, lens = TK.selection_path_plain(x, layout,
                                                             **named)
    np.testing.assert_array_equal(lens.numpy(), lengths)
    for i, r in enumerate(reads):
        want = _oracle_path(r, float(props[i]))
        assert (reached[i].tolist(), recounted[i].tolist(),
                bool(skip[i])) == want, (i, r)
    assert skip.any() == with_n


HOMOPOLYMER_WINDOW_OPS = sum((152 // k) * (2 * k + 5 * (k - 1) + 4)
                             for k in range(2, 7))


@pytest.mark.parametrize("read,variant,ops", [
    # every k reached (each modal count ties the best score), k = 2 alone
    # recounted: unpack 1 + rolling code 3 + recount 5 a base, the windows
    ("A" * 152, "full", 152 * 9 + HOMOPOLYMER_WINDOW_OPS),
    ("A" * 152, "no_greedy", 152 + HOMOPOLYMER_WINDOW_OPS),
    # no modal update (4 a window) and the same path
    ("A" * 152, "winmin_only",
     152 + HOMOPOLYMER_WINDOW_OPS - 4 * sum(152 // k for k in range(2, 7))),
    # more than 20 Ns: the N count alone
    ("N" * 21 + "CAG" * 43, "full", 150),
])
def test_scan_ops_by_hand(read, variant, ops):
    bases = np.frombuffer(read.encode(), np.uint8)[None, :].copy()
    lengths = np.array([len(read)], np.int32)
    pad = np.zeros((1, 152), np.uint8)
    pad[0, :len(read)] = bases
    x, named = _entry("ascii", pad, lengths, np.array([0.8]))
    b = T.scan_bound(x, "ascii", variant, **named)
    assert b["ops"] == ops
    assert b["bytes"] == 152 + 4 + 20 + 20 + 12
    terms = {"bytes": b["bytes"] / T.HBM_BYTES_PER_S,
             "operations": ops / T.INT32_OPS_PER_S}
    assert b["bound_by"] == max(terms, key=terms.get)
    assert b["bound_ms"] == pytest.approx(max(terms.values()) * 1e3)


def test_bound_counts_only_the_reached_k():
    """On the bench mix, the path-based count is well under every k's
    windows, modal and recount on every read, and each entry of the same
    reads needs the same operations (only the bytes differ)."""
    bases, lengths = T.bench_batch(512, 152)
    props = np.full(512, 0.8)
    bounds = {lay: T.scan_bound(x, lay, **named) for lay, (x, named) in
              ((lay, _entry(lay, bases, lengths, props))
               for lay in ("n8", "ascii", "packed"))}
    every_k = 512 * (152 * (1 + 3 + 5 * 5) + sum(
        (152 // k) * (2 * k + 5 * (k - 1) + 4) for k in range(2, 7)))
    ops = {b["ops"] for b in bounds.values()}
    assert len(ops) == 1 and ops.pop() < every_k / 2
    assert bounds["n8"]["bytes"] == 512 * (152 // 4 + 11 + 12)
    assert bounds["packed"]["bytes"] == 512 * (152 // 4 + 152 // 8 + 44 + 12)
    no_modal = T.scan_bound(*_entry("n8", bases, lengths, props)[:1], "n8",
                            "no_modal")
    assert no_modal["ops"] > bounds["n8"]["ops"]


def test_clocked_form_needs_the_card():
    x = torch.zeros((2, 49), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmer_cuda.repeat_scan_clocked(x, "n8")
