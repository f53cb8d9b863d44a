"""Breaks planted under the timed path, for the control and the fault tests.

Each function patches the imported program once (`run.main(patches=...)`
calls it after the entry has imported the port) and leaves the rest of the
run as it is, so the comparison has to catch the break:

- `control_no_greedy`: the repeat scan's exact recount skipped, the modal
  window count standing in for it (the kernel's own `no_greedy` form): the
  step a later change would be tempted by, since the recount is a quarter of
  the kernel's cycles. It is the benchmark's control.
- `answer_altered`: every non-zero repeat count one too high, where the
  scan produces it.
- `half_batch`: the second half of every scan call's rows come back empty.
- `stale_result`: each scan call returns the previous call's results, and
  the first call none (a result buffer reused before its copy finished).
"""

from __future__ import annotations


def _wrap_scan(transform):
    from strling_tpu_torch.ops import kmer_cuda

    orig = kmer_cuda.repeat_scan

    def scan(*a, **k):
        return transform(orig, a, k)

    kmer_cuda.repeat_scan = scan


def control_no_greedy():
    def t(orig, a, k):
        k = dict(k, variant="no_greedy")
        return orig(*a, **k)

    _wrap_scan(t)


def answer_altered():
    def t(orig, a, k):
        code, ulen, cnt = orig(*a, **k)
        return code, ulen, cnt + (cnt > 0).to(cnt.dtype)

    _wrap_scan(t)


def half_batch():
    def t(orig, a, k):
        code, ulen, cnt = (x.clone() for x in orig(*a, **k))
        h = len(cnt) // 2
        for x in (code, ulen, cnt):
            x[h:] = 0
        return code, ulen, cnt

    _wrap_scan(t)


def stale_result():
    import torch

    last = []

    def t(orig, a, k):
        out = orig(*a, **k)
        prev = last[0] if last else tuple(x[:0] for x in out)
        last[:] = [tuple(x.clone() for x in out)]
        n = len(out[2])
        res = []
        for x, p in zip(out, prev):
            y = torch.zeros_like(x)
            m = min(n, len(p))
            y[:m] = p[:m].to(y.device)
            res.append(y)
        return tuple(res)

    _wrap_scan(t)


ALL = {"control_no_greedy": control_no_greedy, "answer_altered": answer_altered,
       "half_batch": half_batch, "stale_result": stale_result}
