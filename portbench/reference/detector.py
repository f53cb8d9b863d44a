"""The repeat-unit detector in plain PyTorch, and the path its k-selection
takes on each read.

A frozen copy of the port's plain detector (`strling_tpu_torch/ops/kmer.py`:
`_window_min_rotation`, `_modal_code`, `_modal_code_by_value`,
`_decode_ascii`, `_match_mask`, `_exact_count`, `_detect` with the pairwise
modal and the full variant) and of its host thresholds (`_host_thresholds`),
which follow STRling's `get_repeat` (utils.nim:236-271). It is kept here so
that the benchmark's reference and its roofline do not move when the program
does. It runs on whatever device its tensors are on.

`detect(bases, lengths, props)` takes ASCII rows and float64 proportions and
returns (unit ASCII [B, 6] uint8, unit length [B], count [B]) as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

KS = (2, 3, 4, 5, 6)
DECODE_ASCII = np.frombuffer(b"ACTG", dtype=np.uint8)


def host_thresholds(lengths: np.ndarray, props: np.ndarray):
    """float64 thresholds, as Nim computes them (utils.nim:251,259)."""
    lengths = np.asarray(lengths).astype(np.float64)
    props = np.asarray(props, np.float64)
    te = np.empty((len(lengths), len(KS)), np.int32)
    tp = np.empty((len(lengths), len(KS)), np.int32)
    for ki, k in enumerate(KS):
        te[:, ki] = (lengths * 0.12 / float(k)).astype(np.int64).astype(np.int32)
        tp[:, ki] = (lengths * props / float(k)).astype(np.int64).astype(np.int32)
    return te, tp


def _window_min_rotation(codes, lengths, k):
    B, L = codes.shape
    W = L // k
    w = codes[:, : W * k].reshape(B, W, k)
    vals = []
    for r in range(k):
        f = torch.zeros((B, W), dtype=torch.int32, device=codes.device)
        for m in range(k):
            f = f * 4 + w[:, :, (m + r) % k]
        vals.append(f)
    wmin = torch.stack(vals, dim=-1).amin(dim=-1)
    win_end = (torch.arange(W, dtype=torch.int32, device=codes.device) + 1) * k
    valid = win_end[None, :] <= lengths[:, None]
    return wmin, valid


def _modal_code(wmin, valid):
    B, W = wmin.shape
    wminm = torch.where(valid, wmin, -1)
    eq = wminm[:, :, None] == wminm[:, None, :]
    total = eq.sum(dim=1, dtype=torch.int32)
    idx = torch.arange(W, dtype=torch.int32, device=wmin.device)
    lastmax = torch.where(eq, idx[None, :, None], -1).amax(dim=1)
    M = torch.where(valid, total, 0).amax(dim=1)
    cand = (valid & (total == M[:, None]) & (lastmax == idx[None, :])
            & (M[:, None] > 0))
    jstar = cand.to(torch.int32).argmax(dim=1)
    code = torch.gather(wminm, 1, jstar[:, None])[:, 0]
    code = torch.where(M > 0, code, -1)
    return code, M


def _modal_code_by_value(wmin, valid, k):
    B, W = wmin.shape
    V = 1 << (2 * k)
    dev = wmin.device
    wminm = torch.where(valid, wmin, -1)
    eq = wminm[:, :, None] == torch.arange(V, dtype=torch.int32, device=dev)
    tot = eq.sum(dim=1, dtype=torch.int32)
    idx = torch.arange(W, dtype=torch.int32, device=dev)
    last = torch.where(eq, idx[None, :, None], -1).amax(dim=1)
    score = torch.where(tot > 0, tot * (W + 1) - last, -1)
    v = score.argmax(dim=1)
    M = torch.gather(tot, 1, v[:, None])[:, 0]
    code = torch.where(M > 0, v.to(torch.int32), -1)
    return code, M


def _decode_ascii(code, k):
    code = torch.where(code < 0, (1 << (2 * k)) - 1, code)
    shifts = torch.tensor([2 * (k - 1 - m) for m in range(k)],
                          dtype=torch.int32, device=code.device)
    digits = (code[:, None] >> shifts[None, :]) & 3
    dec = torch.from_numpy(DECODE_ASCII.copy()).to(code.device)
    return dec[digits.long()]


def _match_mask(bases, lengths, kmer_ascii, k):
    B, L = bases.shape
    m = torch.ones((B, L), dtype=torch.bool, device=bases.device)
    for off in range(k):
        shifted = torch.nn.functional.pad(bases[:, off:], (0, off))
        m = m & (shifted == kmer_ascii[:, off][:, None])
    pos = torch.arange(L, dtype=torch.int32, device=bases.device)
    return m & ((pos[None, :] + k) <= lengths[:, None])


def _exact_count(bases, lengths, kmer_ascii, k):
    B, L = bases.shape
    m = _match_mask(bases, lengths, kmer_ascii, k)
    count = torch.zeros(B, dtype=torch.int32, device=bases.device)
    next_free = torch.zeros(B, dtype=torch.int32, device=bases.device)
    for j in range(L):
        can = m[:, j] & (next_free <= j)
        count = count + can.to(torch.int32)
        next_free = torch.where(can, j + k, next_free)
    return count


def detect_tensors(bases, lengths, thresh_early, thresh_prop,
                   greedy: bool = True):
    """The detector on tensors: (unit [B, 6], unit_len [B], count [B],
    reached [B, 5], recounted [B, 5], skip [B]). `greedy=False` lets the
    modal count stand in for the exact recount (the kernel's `no_greedy`
    form, which the benchmark's control runs)."""
    B, L = bases.shape
    dev = bases.device
    lengths = lengths.to(torch.int32)
    thresh_early = thresh_early.to(torch.int32)
    thresh_prop = thresh_prop.to(torch.int32)
    codes = (bases.to(torch.int32) >> 1) & 3
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_read = pos < lengths[:, None]
    skip = ((bases == ord("N")) & in_read).sum(dim=1) > 20

    kmer_counts, exact_counts, kmer_ascii_by_k = [], [], []
    for k in KS:
        wmin, valid = _window_min_rotation(codes, lengths, k)
        if (1 << (2 * k)) < wmin.shape[1]:
            code, cnt = _modal_code_by_value(wmin, valid, k)
        else:
            code, cnt = _modal_code(wmin, valid)
        ka = _decode_ascii(code, k)
        kmer_counts.append(cnt)
        exact_counts.append(_exact_count(bases, lengths, ka, k) if greedy
                            else cnt)
        kmer_ascii_by_k.append(ka)

    best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    res_ki = torch.full((B,), -1, dtype=torch.int32, device=dev)
    res_count = torch.zeros(B, dtype=torch.int32, device=dev)
    reached, recounted = [], []
    for ki, k in enumerate(KS):
        cnt = kmer_counts[ki]
        ex = exact_counts[ki]
        gate1_fail = cnt * k <= best
        newly_done = ~done & gate1_fail & (cnt < thresh_early[:, ki])
        proceed = ~done & ~gate1_fail
        reached.append(~done & ~skip)
        recounted.append(proceed & ~skip)
        done = done | newly_done
        upd = proceed & (ex * k >= best)
        best = torch.where(upd, ex * k, best)
        set_res = upd & (ex > thresh_prop[:, ki])
        res_ki = torch.where(set_res, ki, res_ki)
        res_count = torch.where(set_res, ex, res_count)

    unit = torch.zeros((B, 6), dtype=torch.uint8, device=dev)
    for ki, k in enumerate(KS):
        padded = torch.nn.functional.pad(kmer_ascii_by_k[ki], (0, 6 - k))
        unit = torch.where((res_ki == ki)[:, None], padded, unit)
    ks = torch.tensor(KS, dtype=torch.int32, device=dev)
    unit_len = torch.where(res_ki >= 0, ks[res_ki.clamp(min=0).long()], 0)

    is_homo = res_ki >= 0
    for i in range(1, 6):
        is_homo = is_homo & ((i >= unit_len) | (unit[:, i] == unit[:, 0]))
    res_count = res_count * torch.where(is_homo, unit_len, 1)
    unit_len = torch.where(is_homo, unit_len.clamp(max=1), unit_len)
    col = torch.arange(6, device=dev)[None, :]
    unit = torch.where(col < unit_len[:, None], unit, 0)

    res_count = torch.where(skip, 0, res_count)
    unit = torch.where(skip[:, None], 0, unit)
    unit_len = torch.where(skip, 0, unit_len)
    return (unit, unit_len, res_count, torch.stack(reached, dim=1),
            torch.stack(recounted, dim=1), skip)


def _block_rows(L: int) -> int:
    """Rows a block holds so that the pairwise modal's [B, W, W] tensor of
    k = 2 stays near 256M elements."""
    w = max(1, L // 2)
    return max(256, min(65536, (1 << 28) // (w * w)))


def detect(bases: np.ndarray, lengths: np.ndarray, props: np.ndarray,
           device: torch.device, greedy: bool = True):
    """(unit [B, 6] uint8 ASCII, unit_len [B] int32, count [B] int32) of
    ASCII rows, in blocks on `device`."""
    bases = np.ascontiguousarray(bases, np.uint8)
    lengths = np.asarray(lengths, np.int32)
    B, L = bases.shape
    unit = np.zeros((B, 6), np.uint8)
    ulen = np.zeros(B, np.int32)
    cnt = np.zeros(B, np.int32)
    if B == 0:
        return unit, ulen, cnt
    te, tp = host_thresholds(lengths, props)
    step = _block_rows(L)
    with torch.no_grad():
        for s in range(0, B, step):
            e = min(B, s + step)
            u, ul, c, *_ = detect_tensors(
                torch.from_numpy(bases[s:e]).to(device),
                torch.from_numpy(lengths[s:e]).to(device),
                torch.from_numpy(te[s:e]).to(device),
                torch.from_numpy(tp[s:e]).to(device), greedy=greedy)
            unit[s:e] = u.cpu().numpy()
            ulen[s:e] = ul.cpu().numpy()
            cnt[s:e] = c.cpu().numpy()
    return unit, ulen, cnt
