"""The repeat scan's other forms in strling_tpu_torch vs the JAX package:
the packed entry (2-bit rows + N bitmask), the sorted modal and the
stage-disabled variants, on the plain PyTorch forms (the CPU path of the
CUDA kernel's wrapper). All outputs are integers: equality is exact.
"""

import numpy as np
import pytest
import torch

from strling_tpu.ops import kmer as RK
from strling_tpu.ops import oracle
from strling_tpu.ops.kmer_pallas import _modal_sorted, get_repeat_device_pallas
from strling_tpu_torch.ops import kmer as TK
from strling_tpu_torch.ops import kmer_cuda
from strling_tpu_torch.ops.kmer_cuda import repeat_scan
from strling_tpu_torch.scripts.exp_kernel_timing import f6_tile

from test_torch_kmer import ADVERSARIAL, IUPAC, _batch, _random_reads

torch.set_num_threads(1)


def _tile(seed, L, alphabet="ACGTN", n=1024):
    """n reads of at most L bases: random, phase-shifted and noisy STRs,
    half-STR reads and the adversarial ties, with per-read props."""
    reads, props = _random_reads(seed, n - len(ADVERSARIAL), max_len=L + 1,
                                 alphabet=alphabet)
    reads += [r[:L] for r in ADVERSARIAL]
    props += [0.3] * len(ADVERSARIAL)
    return _batch(reads, props, L)


def _codes(out):
    return [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in out]


def _assert_equal(got, want):
    for g, w in zip(_codes(got), _codes(want)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------- packed


def test_packed_plain_matches_reference_and_pallas():
    """The packed layout's plain form against the reference's XLA packed
    entry and the Pallas kernel (interpret mode) on the unpacked rows: a
    1024-row tile with Ns and thresholds outside u16 (the batches that
    reach the packed entry)."""
    bases, lengths, props = _tile(31, 96)
    props[::3] = -0.05
    props[1::3] = 2000.0
    assert TK.fuse_payload(bases, lengths, props) is None
    packed, nbits = TK.pack_bases(bases)
    te, tp = TK._host_thresholds(lengths, props)
    got = repeat_scan(torch.from_numpy(packed), "packed",
                      *(torch.from_numpy(a) for a in (lengths, te, tp)),
                      nbits=torch.from_numpy(nbits))
    code, ulen, cnt = _codes(got)
    unit, rulen, rcnt = RK._get_repeat_packed_jit(packed, nbits, lengths, te, tp)
    np.testing.assert_array_equal(TK.codes_to_ascii(code, ulen), unit)
    np.testing.assert_array_equal(ulen, rulen)
    np.testing.assert_array_equal(cnt, rcnt)
    ascii_rows = np.asarray(RK.unpack_ascii(packed, nbits))
    _assert_equal(got, get_repeat_device_pallas(ascii_rows, lengths, te, tp,
                                                interpret=True))
    # the thresholds really decide: negative tp keeps every counted read
    assert (cnt[::3] > 0).mean() > 0.9 and (cnt[1::3] == 0).all()


def test_scan_codes_takes_the_packed_branch(monkeypatch):
    """Thresholds outside u16 (and rows over 65535 bases) make the fused
    payload refuse a batch; scan_codes then sends it as 2-bit rows with an
    N bitmask, as scan_codes_dispatch does, and IUPAC batches as ASCII."""
    layouts = []
    real = kmer_cuda.repeat_scan

    def spy(x, layout, *a, **kw):
        layouts.append(layout)
        return real(x, layout, *a, **kw)

    monkeypatch.setattr(kmer_cuda, "repeat_scan", spy)
    reads, props = _random_reads(41, 200)
    bases, lengths, props = _batch(reads, props, 152)
    props[::2] = -0.05
    props[1::4] = 1000.0
    got = TK.scan_codes(bases, lengths, props, "cpu")
    want = RK.scan_codes(bases, lengths, props, backend="xla", bucket=256)
    _assert_equal(got, want)
    iu = bases.copy()
    iu[3, 5] = ord("R")
    _assert_equal(TK.scan_codes(iu, lengths, props, "cpu"),
                  RK.scan_codes(iu, lengths, props, backend="xla", bucket=256))
    assert layouts == ["packed", "ascii"]


def test_cli_index_negative_proportion_matches_reference(tmp_path):
    """`index -p -0.05` scans every window through the packed entry; the
    bed is the reference's byte for byte."""
    from strling_tpu import cli as ref_cli
    from strling_tpu.io.fasta import write_fasta
    from strling_tpu_torch import cli

    rng = np.random.default_rng(4)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 5000)])
    seq = seq[:2000] + "CAG" * 30 + seq[2000:3500] + "AT" * 40 + seq[3500:]
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, {"chr1": seq, "chr2": seq[::-1][:3000]})
    cli.main(["index", "--device", "cpu", "-p", "-0.05", "-g",
              str(tmp_path / "port.str"), fa])
    ref_cli.main(["index", "-p", "-0.05", "-g", str(tmp_path / "ref.str"), fa])
    got = (tmp_path / "port.str").read_bytes()
    assert got == (tmp_path / "ref.str").read_bytes() and got


# ------------------------------------------------------------------- sorted


def _jax_sorted(wmin, valid):
    W, B = wmin.shape[1], wmin.shape[0]
    wm = np.where(valid, wmin, -1).T.astype(np.int32)
    widx = np.broadcast_to(np.arange(W, dtype=np.int32)[:, None], (W, B))
    modal, kcount = _modal_sorted(wm, valid.T, widx, W, B)
    return np.asarray(modal)[0], np.asarray(kcount)[0]


def _windows(seed, B, W, n_codes, prefix=True):
    rng = np.random.default_rng(seed)
    wmin = rng.integers(0, n_codes, (B, W)).astype(np.int32)
    if prefix:
        nvalid = rng.integers(0, W + 1, B)
        nvalid[:4] = 0  # all-invalid rows
        valid = np.arange(W)[None, :] < nvalid[:, None]
    else:
        valid = rng.random((B, W)) < 0.7
    return wmin, valid


def _tie_rows(W):
    """Codes that tie on their totals: the earliest last occurrence wins."""
    rows = [[5, 9, 9, 5], [9, 5, 5, 9], [3, 1, 2, 3, 2, 1], [7] * 3 + [2] * 3,
            [2, 7, 2, 7, 7, 2], [0, 4095, 0, 4095], [63, 62, 62, 63, 1]]
    wmin = np.zeros((len(rows), W), np.int32)
    valid = np.zeros((len(rows), W), bool)
    for i, r in enumerate(rows):
        wmin[i, :len(r)] = r
        valid[i, :len(r)] = True
    return wmin, valid


@pytest.mark.parametrize("W,n_codes", [(1, 64), (7, 4), (33, 16), (50, 64),
                                       (64, 8), (64, 4096)])
def test_modal_sorted_matches_jax_sorted(W, n_codes):
    """The plain sort-based modal against the JAX package's _modal_sorted
    where that one is right (W <= 64), on random, tied and empty rows."""
    wmin, valid = _windows(W, 256, W, n_codes)
    if W >= 6:
        tw, tv = _tie_rows(W)
        wmin, valid = np.concatenate([wmin, tw]), np.concatenate([valid, tv])
    got = TK._modal_code_sorted(torch.from_numpy(wmin), torch.from_numpy(valid))
    want = _jax_sorted(wmin, valid)
    _assert_equal(got, want)
    _assert_equal(got, TK._modal_code(torch.from_numpy(wmin),
                                      torch.from_numpy(valid)))


@pytest.mark.parametrize("W,prefix", [(65, True), (85, True), (200, False),
                                      (1024, True), (3333, True)])
def test_modal_sorted_matches_pairwise_at_any_width(W, prefix):
    wmin, valid = _windows(W, 32 if W > 1000 else 128, W, 64, prefix)
    w, v = torch.from_numpy(wmin), torch.from_numpy(valid)
    _assert_equal(TK._modal_code_sorted(w, v), TK._modal_code(w, v))


def test_modal_sorted_f6_reproducer():
    """F6: 64 distinct codes, then code 10 21 more times (85 windows). The
    JAX form's 6-bit window field wraps and answers 11; the modal is 10
    with 22 occurrences."""
    wmin = np.array([list(range(64)) + [10] * 21], np.int32)
    valid = np.ones_like(wmin, bool)
    code, count = TK._modal_code_sorted(torch.from_numpy(wmin),
                                        torch.from_numpy(valid))
    assert (int(code[0]), int(count[0])) == (10, 22)
    assert _jax_sorted(wmin, valid)[0][0] == 11  # the reference's fault


def test_sorted_detector_f6_tile_matches_oracle():
    """The F6 tile at p = 0.5 (tp = 42 for k = 3, so the planted counts are
    reported): the sorted detector equals the oracle read by read and the
    pairwise detector row by row."""
    bases, lengths = f6_tile()
    props = np.full(1024, 0.5)
    payload, layout = TK.fuse_payload(bases, lengths, props,
                                      return_layout=True)
    assert layout == "w16"
    x = torch.from_numpy(payload)
    got = _codes(repeat_scan(x, layout, modal="sorted"))
    _assert_equal(got, repeat_scan(x, layout, modal="pairwise"))
    units = TK.unpack_unit_codes(got[0], got[1])
    for i in range(1024):
        read = bases[i].tobytes().decode()
        assert (units[i], int(got[2][i])) == oracle.get_repeat(read, 0.5), i
    assert sum(u == "AAT" for u in units[1::2]) == 512


def test_sorted_detector_matches_pairwise_on_corpora():
    bases, lengths, props = _tile(32, 160, n=300)
    reads = IUPAC + ["", "A", "N" * 21 + "A" * 100]
    ib, il, ip = _batch(reads, [0.5] * len(reads), 160)
    for b, l, p in ((bases, lengths, props), (ib, il, ip)):
        te, tp = TK._host_thresholds(l, p)
        args = [torch.from_numpy(a) for a in (b, l, te, tp)]
        _assert_equal(repeat_scan(*args[:1], "ascii", *args[1:], modal="sorted"),
                      repeat_scan(*args[:1], "ascii", *args[1:],
                                  modal="pairwise"))


def test_modal_impl_env_switch():
    """STRLING_MODAL_IMPL is read once at import, as the JAX package reads
    it: "sorted" selects the sorted form, anything else pairwise."""
    import os
    import subprocess
    import sys

    code = ("from strling_tpu_torch.ops import kmer; "
            "print(kmer.MODAL_IMPL, kmer.resolve_modal(None))")
    for env, want in (("sorted", "sorted sorted"),
                      ("bitonic", "pairwise pairwise")):
        e = {k: v for k, v in os.environ.items() if k != "STRLING_MODAL_IMPL"}
        if env:
            e["STRLING_MODAL_IMPL"] = env
        out = subprocess.run([sys.executable, "-c", code], env=e,
                             capture_output=True, text=True, timeout=120)
        assert out.stdout.strip() == want, out.stderr[-2000:]
    with pytest.raises(ValueError, match="modal"):
        TK.resolve_modal("bitonic")


# ----------------------------------------------------------------- variants


@pytest.mark.parametrize("variant", ["no_greedy", "no_modal", "winmin_only"])
@pytest.mark.parametrize("entry", ["ascii", "n8"])
def test_variant_matches_pallas_interpret(variant, entry):
    """Each stage-disabled variant against the Pallas kernel built with the
    same variant (interpret mode): the ASCII entry with Ns, IUPAC bytes and
    short reads, and the kernel's packed=True input of N-free n8 rows."""
    bases, lengths, props = _tile(50, 96, "ACGTN" if entry == "ascii"
                                  else "ACGT")
    if entry == "ascii":
        bases[5::97, 10:40] = ord("N")
        bases[7::61, 3] = ord("R")
    te, tp = TK._host_thresholds(lengths, props)
    if entry == "ascii":
        got = repeat_scan(*(torch.from_numpy(a) for a in (bases,)), "ascii",
                          *(torch.from_numpy(a) for a in (lengths, te, tp)),
                          variant=variant)
        want = get_repeat_device_pallas(bases, lengths, te, tp,
                                        interpret=True, variant=variant)
    else:
        payload, layout = TK.fuse_payload(bases, lengths, props,
                                          return_layout=True)
        assert layout == "n8"
        got = repeat_scan(torch.from_numpy(payload), "n8", variant=variant)
        want = get_repeat_device_pallas(TK.pack_bases(bases)[0], lengths, te,
                                        tp, interpret=True, variant=variant,
                                        packed=True)
    _assert_equal(got, want)
    full = _codes(repeat_scan(*(torch.from_numpy(a) for a in (bases,)),
                              "ascii", *(torch.from_numpy(a)
                                         for a in (lengths, te, tp))))
    assert any((g != f).any() for g, f in zip(_codes(got), full))


def test_variants_reject_unknown_names():
    x = torch.zeros((2, 49), dtype=torch.uint8)
    with pytest.raises(ValueError, match="variant"):
        repeat_scan(x, "n8", variant="no_exact")
    with pytest.raises(ValueError, match="nbits"):
        TK.repeat_codes_plain(torch.zeros((2, 8), dtype=torch.uint8),
                              "packed", torch.zeros(2, dtype=torch.int32),
                              torch.zeros((2, 5), dtype=torch.int32),
                              torch.zeros((2, 5), dtype=torch.int32))


# -------------------------------------------------------------- stage tool


def test_stage_tool_runs_on_cpu(capsys):
    from strling_tpu_torch.scripts import exp_kernel_timing as tool

    results = tool.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    for entry in ("ascii", "n8"):
        assert f"{entry} entry, 4096x152" in out
        for row, _, _ in tool.ROWS:
            assert results[(entry, row)] > 0
    for line in ("sorted modal detector", "needs the card (the kernel's "
                 "clocked form)"):
        assert out.count(line) == 2
    assert sum(ln.strip().split()[0] in {r for r, _, _ in tool.ROWS}
               for ln in out.splitlines() if "ms/batch" in ln) == 10
