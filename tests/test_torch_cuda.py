"""The CUDA repeat-unit kernel against its plain PyTorch twin and the oracle.

This file imports no JAX, so on a machine with a card and without JAX it
runs on its own, skipping the repo's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card the kernel tests skip; the CPU tests hold the twin to the
oracle on the same corpora.
"""

import threading

import numpy as np
import pytest
import torch

from strling_tpu.ops import oracle
from strling_tpu_torch.ops import kmer as TK
from strling_tpu_torch.ops.kmer_cuda import repeat_scan

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _reads(seed, n, L, with_n):
    """Random reads, phase-shifted and noisy STRs, F1-style CAG/TTC
    mixtures and, at L=264, the F2 homopolymers."""
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGTN" if with_n else "ACGT"))
    units = ["AT", "CAG", "AAGGG", "GGGGCC", "A", "ATTCT", "TG", "AAGG"]
    reads = []
    for i in range(n):
        ln = int(rng.integers(1, L + 1))
        u = units[i % len(units)]
        mode = i % 4
        if mode == 0:
            r = "".join(alpha[rng.integers(0, len(alpha), ln)])
        elif mode == 1:
            ph = int(rng.integers(0, len(u)))
            r = (u * (ln // len(u) + 2))[ph: ph + ln]
        elif mode == 2:
            s = list((u * (ln // len(u) + 2))[:ln])
            for _ in range(max(1, ln // 12)):
                s[rng.integers(0, ln)] = alpha[rng.integers(0, len(alpha))]
            r = "".join(s)
        else:
            mix = rng.random(ln // 3 + 1) < rng.uniform(0.2, 0.8)
            r = "".join("CAG" if m else "TTC" for m in mix)[:ln]
        reads.append(r)
    if L >= 264:
        reads[:2] = ["A" * 256, "A" * 264]
    bases = np.zeros((n, L), np.uint8)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    props = rng.choice([0.8, 0.73, 0.6, 0.4], n)
    return reads, bases, lengths, props


def _oracle_check(reads, props, code, ulen, cnt):
    units = TK.unpack_unit_codes(code, ulen)
    for i, (r, p) in enumerate(zip(reads, props)):
        assert (units[i], int(cnt[i])) == oracle.get_repeat(r, float(p)), (i, r)


@pytest.mark.parametrize("L,with_n", [(104, False), (152, True), (264, True)])
def test_twin_matches_oracle(L, with_n):
    reads, bases, lengths, props = _reads(L, 64, L, with_n)
    payload, layout = TK.fuse_payload(bases, lengths, props, return_layout=True)
    code, ulen, cnt = (t.numpy() for t in
                       repeat_scan(torch.from_numpy(payload), layout))
    _oracle_check(reads, props, code, ulen, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("L,with_n", [(104, False), (152, False), (152, True),
                                      (248, False), (264, True)])
def test_kernel_matches_twin_and_oracle(cuda_device, L, with_n):
    reads, bases, lengths, props = _reads(L + 1000 * with_n, 1500, L, with_n)
    payload, layout = TK.fuse_payload(bases, lengths, props, return_layout=True)
    x = torch.from_numpy(payload).to(cuda_device)
    got = repeat_scan(x, layout)
    want = TK.repeat_codes_plain(x, layout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    te, tp = TK._host_thresholds(lengths, props)
    iu = bases.copy()
    iu[5::37, 3] = ord("R")  # the ASCII entry, with IUPAC bytes
    args = [torch.from_numpy(a).to(cuda_device) for a in (iu, lengths, te, tp)]
    got_a = repeat_scan(args[0], "ascii", *args[1:])
    want_a = TK.repeat_codes_plain(args[0], "ascii", *args[1:])
    for g, w in zip(got_a, want_a):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    _oracle_check(reads[:300], props, *(t.cpu().numpy() for t in got))


@pytest.mark.cuda
def test_ascii_entries_on_card(cuda_device):
    """scan_codes with IUPAC bytes (the engine's fallback batches) and
    get_repeat_batch stage four arrays through the pinned buffer."""
    _, bases, lengths, props = _reads(9, 2000, 150, True)
    bases[3::29, 7] = ord("R")
    for fn in (TK.scan_codes, TK.get_repeat_batch):
        for g, w in zip(fn(bases, lengths, props, cuda_device),
                        fn(bases, lengths, props, "cpu")):
            np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_scan_payload_threads_on_card(cuda_device):
    """The numpy-level entry stages through per-thread pinned buffers and
    streams; eight threads at once must each get their own batch's answer."""
    batches = []
    for s in range(8):
        _, bases, lengths, props = _reads(s, 3000 + 100 * s, 152, s % 2 == 1)
        batches.append(TK.fuse_payload(bases, lengths, props, return_layout=True))
    want = [TK.scan_payload(p, len(p), lay, "cpu") for p, lay in batches]
    got = [None] * len(batches)

    def work(i):
        for _ in range(5):
            p, lay = batches[i]
            got[i] = TK.scan_payload(p, len(p), lay, cuda_device)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _ascii_args(bases, lengths, props, dev):
    te, tp = TK._host_thresholds(lengths, props)
    return [torch.from_numpy(a).to(dev) for a in (bases, lengths, te, tp)]


def _same(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("L,with_n", [(152, False), (152, True), (256, True),
                                      (264, True)])
def test_sorted_kernel_matches_plain_and_oracle(cuda_device, L, with_n):
    """The sorted modal (k = 3 has 85 windows at 256bp, past the JAX form's
    64-window field) on payload rows and the ASCII entry."""
    reads, bases, lengths, props = _reads(L + 7, 1500, L, with_n)
    payload, layout = TK.fuse_payload(bases, lengths, props, return_layout=True)
    x = torch.from_numpy(payload).to(cuda_device)
    got = repeat_scan(x, layout, modal="sorted")
    _same(got, TK.repeat_codes_plain(x, layout, modal="sorted"))
    _same(got, repeat_scan(x, layout, modal="pairwise"))
    args = _ascii_args(bases, lengths, props, cuda_device)
    _same(repeat_scan(args[0], "ascii", *args[1:], modal="sorted"),
          TK.repeat_codes_plain(args[0], "ascii", *args[1:], modal="sorted"))
    _oracle_check(reads[:300], props, *(t.cpu().numpy() for t in got))


@pytest.mark.cuda
def test_sorted_kernel_f6_tile(cuda_device):
    """1024 reads of 256bp, every other one ending in 43-52 x AAT, p = 0.5:
    every read as the oracle says."""
    from strling_tpu_torch.scripts.exp_kernel_timing import f6_tile

    bases, lengths = f6_tile()
    props = np.full(1024, 0.5)
    payload, layout = TK.fuse_payload(bases, lengths, props, return_layout=True)
    got = repeat_scan(torch.from_numpy(payload).to(cuda_device), layout,
                      modal="sorted")
    reads = [bases[i].tobytes().decode() for i in range(1024)]
    _oracle_check(reads, props, *(t.cpu().numpy() for t in got))


@pytest.mark.cuda
def test_sorted_kernel_row_limit(cuda_device):
    """The sorted form takes rows up to MAX_L bases (3,333 k = 3 windows,
    sorted in the warp's shared memory) with the plain version's, the
    pairwise form's and the oracle's answers, and refuses longer rows by
    name, as the pairwise form does."""
    from strling_tpu_torch.ops import kmer_cuda

    L = kmer_cuda.MAX_L
    rng = np.random.default_rng(3)
    reads = ["CAG" * (L // 3) + "C", ("AAGGG" * L)[:L - 1],
             "".join(rng.choice(list("ACGT"), L)),
             "".join(rng.choice(["AAT", "AGT"], L // 3, p=[0.8, 0.2])),
             ("AT" * L)[:3075], "".join(rng.choice(list("ACGT"), 3200))]
    bases = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    props = np.array([0.8, 0.6, 0.8, 0.5, 0.4, 0.8])
    args = _ascii_args(bases, lengths, props, cuda_device)
    got = repeat_scan(args[0], "ascii", *args[1:], modal="sorted")
    _same(got, TK.repeat_codes_plain(args[0], "ascii", *args[1:],
                                     modal="sorted"))
    _same(got, repeat_scan(args[0], "ascii", *args[1:], modal="pairwise"))
    _oracle_check(reads, props, *(t.cpu().numpy() for t in got))
    wide = np.zeros((len(reads), L + 8), np.uint8)
    wide[:, :L] = bases
    args = _ascii_args(wide, lengths, props, cuda_device)
    for modal in ("sorted", "pairwise"):
        with pytest.raises(ValueError, match=str(L)):
            repeat_scan(args[0], "ascii", *args[1:], modal=modal)


@pytest.mark.cuda
def test_packed_entry_matches_plain(cuda_device):
    """2-bit rows with an N bitmask and thresholds outside u16, on the
    kernel and through scan_codes."""
    from strling_tpu_torch.ops import kmer_cuda

    reads, bases, lengths, props = _reads(12, 2000, 152, True)
    props[::2] = -0.05
    props[1::4] = 1000.0
    packed, nbits = TK.pack_bases(bases)
    te, tp = TK._host_thresholds(lengths, props)
    x, nb, *rest = [torch.from_numpy(a).to(cuda_device)
                    for a in (packed, nbits, lengths, te, tp)]
    for modal in ("pairwise", "sorted"):
        _same(repeat_scan(x, "packed", *rest, nbits=nb, modal=modal),
              TK.repeat_codes_plain(x, "packed", *rest, nbits=nb, modal=modal))
    kmer_cuda.launches_by.clear()
    for g, w in zip(TK.scan_codes(bases, lengths, props, cuda_device),
                    TK.scan_codes(bases, lengths, props, "cpu")):
        np.testing.assert_array_equal(g, w)
    assert [k[0] for k in kmer_cuda.launches_by] == ["packed"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["no_greedy", "no_modal", "winmin_only"])
def test_variant_kernels_match_plain(cuda_device, variant):
    reads, bases, lengths, props = _reads(20, 1500, 152, True)
    payload, layout = TK.fuse_payload(bases, lengths, props, return_layout=True)
    x = torch.from_numpy(payload).to(cuda_device)
    _same(repeat_scan(x, layout, variant=variant),
          TK.repeat_codes_plain(x, layout, variant=variant))
    args = _ascii_args(bases, lengths, props, cuda_device)
    for modal in ("pairwise", "sorted"):
        _same(repeat_scan(args[0], "ascii", *args[1:], variant=variant,
                          modal=modal),
              TK.repeat_codes_plain(args[0], "ascii", *args[1:],
                                    variant=variant, modal=modal))
    packed, nbits = TK.pack_bases(bases)
    x, nb = (torch.from_numpy(a).to(cuda_device) for a in (packed, nbits))
    _same(repeat_scan(x, "packed", *args[1:], nbits=nb, variant=variant),
          TK.repeat_codes_plain(x, "packed", *args[1:], nbits=nb,
                                variant=variant))


def _layout_inputs(layout, n, dev, seed):
    """(x, named tensors) of `n` reads for `layout`: n8 (no N, 152bp), w8
    (Ns, 152bp), w16 (256bp), ASCII with IUPAC bytes, packed (2-bit rows
    and N bitmask)."""
    L, with_n = {"n8": (152, False), "w8": (152, True), "w16": (256, True),
                 "ascii": (152, True), "packed": (152, True)}[layout]
    _, bases, lengths, props = _reads(seed, n, L, with_n)
    if with_n:
        bases[0, 0] = ord("N")  # so that even one read takes w8/w16
    if layout in ("n8", "w8", "w16"):
        payload, got = TK.fuse_payload(bases, lengths, props,
                                       return_layout=True)
        assert got == layout
        return torch.from_numpy(payload).to(dev), {}
    if layout == "ascii":
        bases[5::37, 3] = ord("R")
    te, tp = TK._host_thresholds(lengths, props)
    named = {"lengths": lengths, "te": te, "tp": tp}
    x = bases
    if layout == "packed":
        x, named["nbits"] = TK.pack_bases(bases)
    return (torch.from_numpy(x).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in named.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "no_greedy", "no_modal",
                                     "winmin_only"])
@pytest.mark.parametrize("layout", ["n8", "w8", "w16", "ascii", "packed"])
def test_warp_kernel_ragged_rows(cuda_device, layout, variant):
    """One warp per read, four warps a block: 1, 31, 33 and 4097 rows (the
    ragged edges of a warp and of a block, and more warps than the card
    holds at once for 4097) give the plain version's answers."""
    for n in (1, 31, 33, 4097):
        x, named = _layout_inputs(layout, n, cuda_device, 40 + n)
        _same(repeat_scan(x, layout, modal="pairwise", variant=variant,
                          **named),
              TK.repeat_codes_plain(x, layout, modal="pairwise",
                                    variant=variant, **named))


@pytest.mark.cuda
def test_warp_kernel_max_l(cuda_device):
    """Reads of MAX_L bases (the largest shared-memory footprint a warp
    takes) on the ASCII and packed entries, against the plain version and
    the oracle."""
    from strling_tpu_torch.ops import kmer_cuda

    L = kmer_cuda.MAX_L
    reads = ["CAG" * (L // 3) + "C", ("AAGGG" * L)[:L],
             "".join(np.random.default_rng(1).choice(list("ACGT"), L)),
             ("AT" * L)[:L - 17]]
    bases = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    props = np.array([0.8, 0.6, 0.8, 0.4])
    args = _ascii_args(bases, lengths, props, cuda_device)
    got = repeat_scan(args[0], "ascii", *args[1:])
    _same(got, TK.repeat_codes_plain(args[0], "ascii", *args[1:]))
    _oracle_check(reads, props, *(t.cpu().numpy() for t in got))
    packed, nbits = TK.pack_bases(bases)
    x, nb = (torch.from_numpy(a).to(cuda_device) for a in (packed, nbits))
    _same(repeat_scan(x, "packed", *args[1:], nbits=nb), got)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", ["f1_w16", "f1_n8", "f2", "f6"])
def test_warp_kernel_fault_rows_match_oracle(cuda_device, tile):
    """The rows of the TPU form's faults on the default (pairwise, warp per
    read) kernel: F1 (k = 3 lane-field carry), F2 (counts of 256 and more),
    F6 (85 windows at k = 3), every row as the oracle says."""
    from strling_tpu_torch.scripts import exp_kernel_timing as T

    bases, lengths, p = {
        "f1_w16": lambda: (*T.f1_tile(256), 0.8),
        "f1_n8": lambda: (*T.f1_tile(248), 0.8),
        "f2": lambda: (*T.f2_rows(), 0.8),
        "f6": lambda: (*T.f6_tile(), 0.5)}[tile]()
    props = np.full(len(lengths), p)
    payload, layout = TK.fuse_payload(bases, lengths, props,
                                      return_layout=True)
    assert layout == ("n8" if tile == "f1_n8" else "w16")
    got = repeat_scan(torch.from_numpy(payload).to(cuda_device), layout)
    reads = [bases[i, :lengths[i]].tobytes().decode()
             for i in range(len(lengths))]
    _oracle_check(reads, props, *(t.cpu().numpy() for t in got))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [511, 512])
def test_warp_kernel_table_width(cuda_device, L):
    """Rows of up to 511 bases count in u8 table entries, longer rows in
    u16: homopolymers and dinucleotides filling the row (one code 255 or
    256 times at k = 2) give the plain version's and the oracle's answers on
    both sides of the switch."""
    reads = ["A" * L, ("CA" * L)[:L], "G" * (L - 1), ("AAG" * L)[:L]]
    bases = np.zeros((len(reads), L), np.uint8)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    props = np.full(len(reads), 0.8)
    args = _ascii_args(bases, lengths, props, cuda_device)
    got = repeat_scan(args[0], "ascii", *args[1:])
    _same(got, TK.repeat_codes_plain(args[0], "ascii", *args[1:]))
    _oracle_check(reads, props, *(t.cpu().numpy() for t in got))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["n8", "w8", "w16", "ascii", "packed"])
def test_clocked_form_matches_plain(cuda_device, layout):
    """The detector's clocked form (the stage split's source) gives the
    plain version's answers on every layout, at ragged row counts, and
    counts cycles in every stage."""
    from strling_tpu_torch.ops import kmer_cuda

    for n in (33, 4097):
        x, named = _layout_inputs(layout, n, cuda_device, 70 + n)
        kmer_cuda.stage_cycles(cuda_device)
        got = kmer_cuda.repeat_scan_clocked(x, layout, **named)
        cycles = kmer_cuda.stage_cycles(cuda_device)
        _same(got, TK.repeat_codes_plain(x, layout, modal="pairwise",
                                         **named))
        assert set(cycles) == set(kmer_cuda.STAGES)
        assert min(cycles.values()) > 0, cycles
    assert kmer_cuda.stage_cycles(cuda_device) == dict.fromkeys(
        kmer_cuda.STAGES, 0)


@pytest.mark.cuda
def test_launcher_reports_design(cuda_device):
    """The design in launches_by_design is the one the launcher reports:
    warp per read for both modals, the variants and the clocked forms."""
    from strling_tpu_torch.ops import kmer_cuda

    x, _ = _layout_inputs("n8", 100, cuda_device, 3)
    kmer_cuda.launches_by_design.clear()
    for modal in ("pairwise", "sorted"):
        for variant in ("full", "no_greedy", "no_modal"):
            repeat_scan(x, "n8", modal=modal, variant=variant)
        kmer_cuda.repeat_scan_clocked(x, "n8", modal=modal)
    assert dict(kmer_cuda.launches_by_design) == {
        ("n8", "pairwise", "full", "warp_per_read"): 1,
        ("n8", "pairwise", "no_greedy", "warp_per_read"): 1,
        ("n8", "pairwise", "no_modal", "warp_per_read"): 1,
        ("n8", "sorted", "full", "warp_per_read"): 1,
        ("n8", "sorted", "no_greedy", "warp_per_read"): 1,
        ("n8", "sorted", "no_modal", "warp_per_read"): 1,
        ("n8", "pairwise", "stages", "warp_per_read"): 1,
        ("n8", "sorted", "stages", "warp_per_read"): 1,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["n8", "w8", "w16", "ascii", "packed"])
def test_clocked_sorted_form_matches_plain(cuda_device, layout):
    """The sorted detector's clocked form gives the plain version's answers
    on every layout, at ragged row counts, and counts cycles in every
    stage."""
    from strling_tpu_torch.ops import kmer_cuda

    for n in (33, 4097):
        x, named = _layout_inputs(layout, n, cuda_device, 90 + n)
        kmer_cuda.stage_cycles(cuda_device)
        got = kmer_cuda.repeat_scan_clocked(x, layout, modal="sorted",
                                            **named)
        cycles = kmer_cuda.stage_cycles(cuda_device)
        _same(got, TK.repeat_codes_plain(x, layout, modal="sorted", **named))
        assert min(cycles.values()) > 0, cycles


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "no_greedy"])
@pytest.mark.parametrize("layout", ["n8", "w8", "w16", "ascii", "packed"])
def test_sorted_warp_kernel_every_layout(cuda_device, layout, variant):
    """The sorted modal's warp form on every layout (ASCII with IUPAC
    bytes, packed 2-bit rows with their N bitmask, w16 rows of 256 bases
    with 85 k = 3 windows, past the registers' 64) at 1, 31, 33 and 4097
    rows, against the plain version; the pairwise form gives the same."""
    for n in (1, 31, 33, 4097):
        x, named = _layout_inputs(layout, n, cuda_device, 110 + n)
        got = repeat_scan(x, layout, modal="sorted", variant=variant,
                          **named)
        _same(got, TK.repeat_codes_plain(x, layout, modal="sorted",
                                         variant=variant, **named))
        _same(got, repeat_scan(x, layout, modal="pairwise", variant=variant,
                               **named))


@pytest.mark.cuda
def test_sorted_warps_per_sm(cuda_device):
    """The sorted form holds at least as many warps an SM as the pairwise
    one (no count table), and a form too large for a block is refused."""
    from strling_tpu_torch.ops import kmer_cuda

    for layout in ("n8", "ascii", "packed"):
        pw = kmer_cuda.warps_per_sm(layout, 152, "pairwise")
        so = kmer_cuda.warps_per_sm(layout, 152, "sorted")
        assert 4 <= pw <= so <= 64, (layout, pw, so)
    assert kmer_cuda.warps_per_sm("ascii", kmer_cuda.MAX_L, "sorted") >= 4
    with pytest.raises(RuntimeError, match="occupancy"):
        kmer_cuda.warps_per_sm("ascii", 20 * kmer_cuda.MAX_L, "sorted")


# ------------------------------------------------ the spec path, the parallel
# layer at a world of one (NCCL) and the device forms, on the card


def _small_str_bam(path):
    """Background pairs, an anchored CAG read, a soft-clipped CAG read and
    an unplaced pair (tests/test_extract.py's scenario)."""
    from strling_tpu_torch.io import BamRecord, write_bam

    rng = np.random.default_rng(7)
    alpha = np.array(list("ACGT"))

    def seq(n):
        return "".join(alpha[rng.integers(0, 4, n)])

    recs = []
    for i in range(300):
        pos, isz = 1000 + i * 29, 350 + int(rng.integers(-30, 30))
        recs.append(BamRecord(f"bg{i}", 99, 0, pos, 60, "100M", 0,
                              pos + isz - 100, isz, seq(100)))
        recs.append(BamRecord(f"bg{i}", 147, 0, pos + isz - 100, 60, "100M",
                              0, pos, -isz, seq(100)))
    recs.append(BamRecord("str1", 97, 0, 50000, 60, "100M", 0, 50250, 350,
                          seq(100)))
    recs.append(BamRecord("str1", 145, 0, 50250, 0, "100M", 0, 50000, -350,
                          "CAG" * 33 + "C"))
    recs.append(BamRecord("clip1", 99, 0, 50100, 60, "100M", 0, 50300, 300,
                          seq(100)))
    recs.append(BamRecord("clip1", 147, 0, 50300, 60, "60S40M", 0, 50100,
                          -300, "CAG" * 20 + seq(40)))
    recs.append(BamRecord("unp1", 77, -1, -1, 0, "*", -1, -1, 0,
                          "GAA" * 33 + "G"))
    recs.append(BamRecord("unp1", 141, -1, -1, 0, "*", -1, -1, 0,
                          "TTC" * 33 + "T"))
    recs.sort(key=lambda r: (r.tid if r.tid >= 0 else 1 << 30, r.pos))
    write_bam(path, "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000000\n",
              [("chr1", 1000000)], recs)


@pytest.mark.cuda
def test_spec_extract_on_the_card_equals_cpu(cuda_device, tmp_path):
    """The spec path scans through the kernel's ASCII entry on the card and
    gives the --device cpu treads."""
    from strling_tpu_torch.core.extract import extract
    from strling_tpu_torch.io import Bam
    from strling_tpu_torch.ops import kmer_cuda

    path = str(tmp_path / "s.bam")
    _small_str_bam(path)
    before = kmer_cuda.launches_by[("ascii", TK.MODAL_IMPL, "full")]
    got = extract(Bam(path), None, None, device=cuda_device)[0]
    assert kmer_cuda.launches_by[("ascii", TK.MODAL_IMPL, "full")] > before
    want = extract(Bam(path), None, None, device=torch.device("cpu"))[0]
    assert np.array_equal(got.data, want.data) and got.qnames == want.qnames
    assert {"str1", "clip1", "unp1"} <= set(got.qnames)


@pytest.mark.cuda
def test_device_forms_on_the_card_equal_cpu(cuda_device):
    from strling_tpu_torch.ops.cluster_torch import segment_ids
    from strling_tpu_torch.ops.genotyper_torch import genotype_model_batch

    rng = np.random.default_rng(29)
    pos = np.sort(rng.integers(0, 200_000, 400)).astype(np.int64)
    assert np.array_equal(segment_ids(pos, 400, cuda_device),
                          segment_ids(pos, 400, "cpu"))
    ssc = rng.integers(0, 3000, 100)
    depth = rng.uniform(0.5, 80.0, 100)
    rulen = rng.integers(1, 7, 100)
    got = genotype_model_batch(ssc, depth, rulen, cuda_device)
    want = genotype_model_batch(ssc, depth, rulen, "cpu")
    ok = (np.isnan(got) & np.isnan(want)) | (
        np.abs(got - want) <= 64 * np.spacing(np.abs(want)))
    assert ok.all()


@pytest.fixture
def nccl_world_of_one(cuda_device):
    import torch.distributed as dist

    from strling_tpu_torch.parallel.mesh import init_distributed

    assert init_distributed("cuda") == cuda_device
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    yield cuda_device
    dist.destroy_process_group()


@pytest.mark.cuda
def test_oe_barrier_and_sharded_step_on_nccl(nccl_world_of_one):
    """A world of one on NCCL: the O/E barrier against the host math (a
    NaN and an inf among the ratios) and the sharded step against the
    kernel on the whole batch."""
    from strling_tpu_torch.parallel.call_dist import rank_oes_on_mesh
    from strling_tpu_torch.parallel.dryrun import sharded_step_on_rank

    dev = nccl_world_of_one
    oes = np.array([0.5, np.nan, 2.0, np.inf, 0.5, -1.0], np.float32)
    allv = np.sort(oes)
    want = (np.searchsorted(allv, oes, side="left").astype(np.float32)
            / np.float32(len(oes) - 1))
    assert rank_oes_on_mesh(oes, dev).tobytes() == want.tobytes()
    on_card = sharded_step_on_rank(dev)
    on_cpu = sharded_step_on_rank(torch.device("cpu"))
    for a, b in zip(on_card, on_cpu):
        assert np.array_equal(a, b)


# ------------------------------------------------------ several cards


def _cards(n: int) -> list:
    """Every card present, or a skip when there are fewer than `n`."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} CUDA devices, {have} present")
    return [torch.device("cuda", i) for i in range(have)]


@pytest.mark.cuda
def test_extract_devices_all_equals_one_card(tmp_path):
    """Scan batches round robin over every card (`--devices all`) give the
    treads of one card, with a launch on each card; each card keeps its own
    kernel attributes and its own clocked-form stage counters."""
    from strling_tpu_torch.ops import kmer_cuda
    from strling_tpu_torch.parallel.dryrun import check_round_robin

    cards = _cards(2)
    check_round_robin(cards[0], cards, str(tmp_path / "rr.bam"))
    _, bases, lengths, props = _reads(31, 600, 152, True)
    for dev in cards:
        kmer_cuda.stage_cycles(dev)
    for dev in cards:
        x, *named = _ascii_args(bases, lengths, props, dev)
        got = kmer_cuda.repeat_scan_clocked(x, "ascii", *named)
        _same(got, TK.repeat_codes_plain(x, "ascii", *named,
                                         modal=TK.MODAL_IMPL))
    for dev in cards:
        assert min(kmer_cuda.stage_cycles(dev).values()) > 0, dev


RANK_NCCL = """
import json, sys
sys.modules["jax"] = None
sys.modules["strling_tpu"] = None
from strling_tpu_torch.parallel.dryrun import dryrun_multichip
from strling_tpu_torch.parallel.mesh import init_distributed
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dev = init_distributed("cuda", init_method="file://" + init, rank=rank,
                       world_size=world)
with open(out % rank, "w") as fh:
    json.dump(dict(dryrun_multichip(dev), device=str(dev)), fh)
"""


@pytest.mark.cuda
def test_four_rank_nccl_dryrun(tmp_path):
    """dryrun_multichip at world 4, a card a rank: NCCL, the (2, 2) mesh,
    the round robin over every card in every rank, the golden chain."""
    import json

    from strling_tpu_torch.scripts.ranks import run_ranks

    cards = _cards(4)
    out = str(tmp_path / "rank%d.json")
    run_ranks(RANK_NCCL, 4, str(tmp_path / "init"), [out], timeout=600)
    res = []
    for r in range(4):
        with open(out % r) as fh:
            res.append(json.load(fh))
    assert [o["device"] for o in res] == [f"cuda:{r}" for r in range(4)]
    assert all(o["backend"] == "nccl" and o["world"] == 4 for o in res)
    assert all(o["extract_devices"] == len(cards) and o["launches"] > 0
               for o in res)
    assert res[0]["golden_chain"] == "byte-identical"
