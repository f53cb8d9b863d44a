"""Generate the hand-assembled fqzcomp full-stream fixture for
tests/test_fqz_fixtures.py (and
tests/test_torch_cram_codecs.py).

Deliberately does NOT import io/cramwrite.py: the range coder and adaptive
model below are re-derived from the DECODER's arithmetic (io/csrc/cram.cc
RangeDec/AModel — 32-bit range, 2^24 renorm, 5-byte prefetch with leading
cache dummy, +16 move-up-one model renormalised at 2^16-16), so the frozen
bytes pin the wire format against BOTH sides: a drift in either the Python
encoder or the C++ decoder breaks the fixture test.

Prints the fixture bytes + expected output as Python literals; the test
file freezes them. Run once; rerun only if the fixture design changes.

Port of the JAX package's `scripts/gen_fqz_fixture.py`; its output is the
same, and its check opens the port's own engine (`io.bam._load`):

    python -m strling_tpu_torch.scripts.gen_fqz_fixture
"""

import numpy as np

STEP = 16
MAX_TOT = (1 << 16) - STEP


class RC:
    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.ffnum = 0
        self.out = bytearray()

    def _shift_low(self):
        carry = self.low >> 32
        if (self.low & 0xFFFFFFFF) < 0xFF000000 or carry:
            self.out.append((self.cache + carry) & 0xFF)
            while self.ffnum:
                self.out.append((0xFF + carry) & 0xFF)
                self.ffnum -= 1
            self.cache = (self.low >> 24) & 0xFF
        else:
            self.ffnum += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, cum, freq, tot):
        r = self.range // tot
        self.low += cum * r
        self.range = r * freq
        while self.range < (1 << 24):
            self.range <<= 8
            self._shift_low()

    def finish(self):
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class Model:
    def __init__(self, n):
        self.freq = [1] * n
        self.sym = list(range(n))
        self.total = n

    def encode(self, rc, s):
        x = self.sym.index(s)
        cum = sum(self.freq[:x])
        rc.encode(cum, self.freq[x], self.total)
        self.freq[x] += STEP
        self.total += STEP
        if x > 0 and self.freq[x] > self.freq[x - 1]:
            self.freq[x], self.freq[x - 1] = self.freq[x - 1], self.freq[x]
            self.sym[x], self.sym[x - 1] = self.sym[x - 1], self.sym[x]
        if self.total > MAX_TOT:
            self.total = 0
            for i in range(len(self.freq)):
                self.freq[i] -= self.freq[i] >> 1
                self.total += self.freq[i]


def build():
    # header: vers=5, gflags = MULTI_PARAM|HAVE_STAB|DO_REV = 7, nparam=2,
    # max_sel=1, stab = [0, 1*255] as the hand-RLE'd array 01 FF 00
    hdr = bytes([5, 7, 2, 1]) + b"\x01\xff\x00"
    # param 0: context=0, pflags=DO_LEN|DO_SEL=12, max_sym=4, qbits=2,
    # qshift=1, qloc=0, sloc=12, ploc=0, dloc=0 (no tables)
    p0 = (b"\x00\x00" + bytes([12, 4, (2 << 4) | 1, (0 << 4) | 12,
                               (0 << 4) | 0]))
    # param 1: context=0x0100, pflags=DO_DEDUP=2, max_sym=4, all locs 0
    p1 = (b"\x00\x01" + bytes([2, 4, 0, 0, 0]))
    hdr += p0 + p1

    # records: (selector, explicit_len|None, rev, dup, quals)
    recs = [
        (0, 5, 0, None, [1, 2, 3, 0, 1]),
        (1, None, 1, 0, [2, 2, 1, 0, 3]),
        (1, None, 0, 1, None),            # dup of rec1's unreversed bytes
        (0, 3, 0, None, [3, 3, 3]),
    ]
    stab = [0] + [1] * 255
    params = [
        dict(context=0, pflags=12, qbits=2, qshift=1, qloc=0, sloc=12,
             ploc=0, dloc=0),
        dict(context=0x0100, pflags=2, qbits=0, qshift=0, qloc=0, sloc=0,
             ploc=0, dloc=0),
    ]
    gmax = 4
    rc = RC()
    qual = {}
    lens = [Model(256) for _ in range(4)]
    dupm, selm, revm = Model(2), Model(256), Model(2)
    first = True
    prev = None
    out = []
    rev_spans = []
    for sel, ln, rv, dup, quals in recs:
        selm.encode(rc, sel)
        p = params[stab[sel]]
        if first or (p["pflags"] & 4):
            for i in range(4):
                lens[i].encode(rc, (ln >> (8 * i)) & 0xFF)
            rec_len = ln
        first = False
        revm.encode(rc, rv)
        start = len(out)
        if p["pflags"] & 2:
            dupm.encode(rc, dup)
            if dup == 1:
                out.extend(prev)
                if rv:
                    rev_spans.append((start, rec_len))
                prev = list(out[start:])
                continue
        ctx = p["context"]
        qctx = 0
        q1 = 0
        delta = 0
        for i in range(rec_len):
            m = qual.setdefault(ctx & 0xFFFF, Model(gmax))
            q = quals[i]
            m.encode(rc, q)
            out.append(q)  # qmap is identity (no HAVE_QMAP)
            qctx = (qctx << p["qshift"]) + q  # qtab identity
            ctx = p["context"]
            if p["qbits"]:
                ctx += (qctx & ((1 << p["qbits"]) - 1)) << p["qloc"]
            pos = rec_len - 1 - i
            # ptab/dtab all-zero (absent): no contribution
            if p["pflags"] & 8:
                ctx += sel << p["sloc"]
            delta += q1 != q
            q1 = q
        if rv:
            rev_spans.append((start, rec_len))
        prev = list(out[start:])
    blob = hdr + rc.finish()
    for s, n in rev_spans:
        out[s:s + n] = out[s:s + n][::-1]
    return blob, bytes(out)


def main():
    blob, want = build()
    print("FIXTURE =", repr(blob))
    print("EXPECTED =", repr(want))
    # validate against the native decoder
    from strling_tpu_torch.io.bam import _load

    lib = _load()
    buf = np.zeros(len(want) + 8, np.uint8)
    n = lib.sio_fqz_decode(blob, len(blob), len(want), buf, len(buf))
    got = bytes(buf[:len(want)])
    assert n == len(want) and got == want, (n, got, want)
    print("# native decoder agrees")


if __name__ == "__main__":
    main()
