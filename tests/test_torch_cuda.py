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
