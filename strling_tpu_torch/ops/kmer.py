"""Batched repeat-unit detection for `extract`/`index`, in PyTorch.

Port of `strling_tpu.ops.kmer`. The reference detects the repeat unit of one
read at a time in Nim (src/strpkg/utils.nim:236-271, its run-time
bottleneck); here a whole [B, L] batch goes through one call:

  1. per-k (k=2..6) non-overlapping window codes, each the minimum over the
     window's cyclic rotations (utils.nim:10-35);
  2. the modal window code per read with the reference's running-argmax
     tie-break (utils.nim:192-198);
  3. an exact non-overlapping recount of the decoded modal k-mer
     (utils.nim:254), where N and other IUPAC bytes never match;
  4. the k-selection state machine against per-read thresholds
     (utils.nim:249-269);
  5. the homopolymer reduction (utils.nim:220-233,271).

The plain tensor form below (`get_repeat_device` and its helpers) is the
CPU path and the reference that the CUDA kernel (`ops/kmer_cuda.py`) is held
to. The numpy helpers (`fuse_payload`, thresholds, code conversions) are
copies of the JAX package's, which cannot be imported without JAX; tests hold
them byte-equal.

Float-sensitive thresholds (int(len*0.12/k), int(len*proportion/k)) are
computed on the host in float64 so the device logic is pure integer.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

KS = (2, 3, 4, 5, 6)
DECODE_ASCII = np.frombuffer(b"ACTG", dtype=np.uint8)

# ------------------------------------------------------------ numpy helpers

_ASCII_OK = np.zeros(256, np.bool_)
_ASCII_OK[[0, ord("A"), ord("C"), ord("G"), ord("T"), ord("N")]] = True

# Fused wire layouts (ops/kmer.py:279-336 of the JAX package):
#   "w8"  [R, 3L/8 + 11]: 2-bit codes + N bitmask + u8 meta (L <= 248)
#   "n8"  [R, L/4 + 11]:  2-bit codes + u8 meta, no N plane (N-free batch)
#   "w16" [R, 3L/8 + 22]: 2-bit codes + N bitmask + u16 LE meta (L > 248)
# Byte t of the code plane holds position 4t+m in bits 2m..2m+1; byte t of
# the N plane holds position 8t+m in bit m. Row widths are ambiguous between
# n8 and w8/w16, so the layout always travels with the payload.
FUSE_META8 = 11   # 5x te u8 + 5x tp u8 + length u8
FUSE_META16 = 22  # 5x te u16 + 5x tp u16 + length u16, little-endian
META8_MAX_L = 248


def _host_thresholds(lengths: np.ndarray, props: np.ndarray):
    """float64 thresholds, exactly as Nim computes them (utils.nim:251,259)."""
    lengths = lengths.astype(np.float64)
    te = np.empty((len(lengths), len(KS)), np.int32)
    tp = np.empty((len(lengths), len(KS)), np.int32)
    for ki, k in enumerate(KS):
        te[:, ki] = (lengths * 0.12 / float(k)).astype(np.int64).astype(np.int32)
        tp[:, ki] = (lengths * props / float(k)).astype(np.int64).astype(np.int32)
    return te, tp


def pack_bases(bases: np.ndarray):
    """[B, L] ASCII -> ([B, L/4] 2-bit codes, [B, L/8] N bitmask), or None
    if the batch has non-ACGTN bytes. L%8==0."""
    if bases.shape[1] % 8 or not _ASCII_OK[bases].all():
        return None
    codes = (bases >> 1) & 3
    packed = (codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4)
              | (codes[:, 3::4] << 6)).astype(np.uint8)
    nbits = np.packbits(bases == ord("N"), axis=1, bitorder="little")
    return packed, nbits


def fuse_payload(bases: np.ndarray, lengths: np.ndarray, props: np.ndarray,
                 return_layout: bool = False):
    """[R, L] ASCII + lengths + props -> u8 single buffer in the smallest
    applicable wire layout, or None if the batch needs the ASCII entry
    (non-ACGTN bytes, L%8, or values exceeding u16). With return_layout,
    returns (payload, layout)."""
    R, L = bases.shape
    if L % 8 or L > 65535 or not _ASCII_OK[bases].all():
        return (None, None) if return_layout else None
    te, tp = _host_thresholds(lengths, props)
    if tp.max(initial=0) > 65535 or tp.min(initial=0) < 0:
        return (None, None) if return_layout else None
    codes = (bases >> 1) & 3
    packed = (codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4)
              | (codes[:, 3::4] << 6)).astype(np.uint8)
    n_mask = bases == ord("N")
    meta8 = L <= META8_MAX_L
    meta = np.empty((R, 11), np.uint8 if meta8 else np.uint16)
    meta[:, :5] = te
    meta[:, 5:10] = tp
    meta[:, 10] = lengths
    mbytes = meta if meta8 else meta.view(np.uint8)
    if meta8 and not n_mask.any():
        layout = "n8"
        parts = [packed, mbytes]
    else:
        layout = "w8" if meta8 else "w16"
        nbits = np.packbits(n_mask, axis=1, bitorder="little")
        parts = [packed, nbits, mbytes]
    out = np.concatenate(parts, axis=1, dtype=np.uint8)
    return (out, layout) if return_layout else out


def payload_geometry(width: int, layout: str):
    """(L, meta_offset, meta_width) of a fused payload row of `width` bytes."""
    if layout == "n8":
        L = (width - FUSE_META8) * 4
        return L, L // 4, FUSE_META8
    if layout in ("w8", "w16"):
        meta_w = FUSE_META8 if layout == "w8" else FUSE_META16
        L = (width - meta_w) * 8 // 3
        return L, 3 * L // 8, meta_w
    raise ValueError(
        f"layout must be the producer-reported 'w8'/'w16'/'n8', got "
        f"{layout!r}: widths are ambiguous between layouts")


def unpack_result(r: np.ndarray):
    """The JAX package's packed result word (cnt | len<<8 | code<<11) ->
    (code, len, count). The port returns the three arrays unpacked."""
    r = np.asarray(r)
    return (r >> 11).astype(np.int32), ((r >> 8) & 7).astype(np.int32), \
        (r & 0xFF).astype(np.int32)


def codes_to_ascii(code: np.ndarray, unit_len: np.ndarray) -> np.ndarray:
    """Vectorized base-4 packed code -> [B, 6] ASCII (zero-padded)."""
    B = len(code)
    out = np.zeros((B, 6), np.uint8)
    for i in range(6):
        shift = 2 * (unit_len - 1 - i)
        digit = (code >> np.maximum(shift, 0)) & 3
        out[:, i] = np.where(i < unit_len, DECODE_ASCII[digit], 0)
    return out


def units_to_strings(unit: np.ndarray, unit_len: np.ndarray) -> list[str]:
    return [bytes(unit[i, : unit_len[i]]).decode() for i in range(len(unit_len))]


def ascii_to_codes(unit: np.ndarray, unit_len: np.ndarray) -> np.ndarray:
    """[B, 6] ASCII unit + lengths -> base-4 packed int32 codes."""
    code = np.zeros(len(unit_len), np.int64)
    for i in range(6):
        active = i < unit_len
        code = np.where(
            active, code * 4 + ((unit[:, i].astype(np.int64) >> 1) & 3), code
        )
    return code.astype(np.int32)


def unpack_unit_codes(code: np.ndarray, klen: np.ndarray) -> list[str]:
    """Base-4 packed unit code -> ACTG string (host-side)."""
    dec = "ACTG"
    return ["".join(dec[(c >> (2 * (l - 1 - i))) & 3] for i in range(l))
            for c, l in zip(code.tolist(), klen.tolist())]


# ---------------------------------------------------- plain tensor detector


def _window_min_rotation(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Min-rotation codes for non-overlapping width-k windows.

    codes: [B, L] int32 in 0..3. Returns (wmin [B, W], valid [B, W] bool)
    where W = L // k and window j covers bases [j*k, (j+1)*k).
    """
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


def _modal_code(wmin: torch.Tensor, valid: torch.Tensor):
    """Modal window code with the reference tie-break (utils.nim:192-198):
    among windows j that are the last occurrence of a code with the maximal
    total M, the smallest j wins. Returns (code [B], count [B]); code is -1
    when there is no valid window."""
    B, W = wmin.shape
    wminm = torch.where(valid, wmin, -1)
    eq = wminm[:, :, None] == wminm[:, None, :]  # [B, i, j]
    total = eq.sum(dim=1, dtype=torch.int32)
    idx = torch.arange(W, dtype=torch.int32, device=wmin.device)
    lastmax = torch.where(eq, idx[None, :, None], -1).amax(dim=1)
    M = torch.where(valid, total, 0).amax(dim=1)
    cand = (valid & (total == M[:, None]) & (lastmax == idx[None, :])
            & (M[:, None] > 0))
    jstar = cand.to(torch.int32).argmax(dim=1)  # first True
    code = torch.gather(wminm, 1, jstar[:, None])[:, 0]
    code = torch.where(M > 0, code, -1)
    return code, M


def _modal_code_by_value(wmin: torch.Tensor, valid: torch.Tensor, k: int):
    """Same contract as _modal_code, counting each possible code directly
    (4^k columns instead of the O(W^2) pairwise tensor; used when 4^k < W)."""
    B, W = wmin.shape
    V = 1 << (2 * k)
    dev = wmin.device
    wminm = torch.where(valid, wmin, -1)
    eq = wminm[:, :, None] == torch.arange(V, dtype=torch.int32, device=dev)
    tot = eq.sum(dim=1, dtype=torch.int32)  # [B, V]
    idx = torch.arange(W, dtype=torch.int32, device=dev)
    last = torch.where(eq, idx[None, :, None], -1).amax(dim=1)  # [B, V]
    # winner: max count, ties -> earliest last occurrence
    score = torch.where(tot > 0, tot * (W + 1) - last, -1)
    v = score.argmax(dim=1)
    M = torch.gather(tot, 1, v[:, None])[:, 0]
    code = torch.where(M > 0, v.to(torch.int32), -1)
    return code, M


def _decode_ascii(code: torch.Tensor, k: int) -> torch.Tensor:
    """Decode [B] codes to [B, k] ASCII bytes; code -1 decodes as 'G'*k
    (Nim: imax = -1 becomes all-ones bits, utils.nim:197,246)."""
    code = torch.where(code < 0, (1 << (2 * k)) - 1, code)
    shifts = torch.tensor([2 * (k - 1 - m) for m in range(k)],
                          dtype=torch.int32, device=code.device)
    digits = (code[:, None] >> shifts[None, :]) & 3
    dec = torch.from_numpy(DECODE_ASCII.copy()).to(code.device)
    return dec[digits.long()]


def _match_mask(bases, lengths, kmer_ascii, k):
    """match[b, j]: the read's kmer matches at offset j (within the read)."""
    B, L = bases.shape
    m = torch.ones((B, L), dtype=torch.bool, device=bases.device)
    for off in range(k):
        shifted = torch.nn.functional.pad(bases[:, off:], (0, off))
        m = m & (shifted == kmer_ascii[:, off][:, None])
    pos = torch.arange(L, dtype=torch.int32, device=bases.device)
    return m & ((pos[None, :] + k) <= lengths[:, None])


def _exact_count(bases, lengths, kmer_ascii, k: int):
    """Non-overlapping occurrences of each read's kmer in its read: Nim
    strutils.count (utils.nim:254), a greedy left-to-right scan advancing by
    k after a match and by 1 otherwise."""
    B, L = bases.shape
    m = _match_mask(bases, lengths, kmer_ascii, k)
    count = torch.zeros(B, dtype=torch.int32, device=bases.device)
    next_free = torch.zeros(B, dtype=torch.int32, device=bases.device)
    for j in range(L):
        can = m[:, j] & (next_free <= j)
        count = count + can.to(torch.int32)
        next_free = torch.where(can, j + k, next_free)
    return count


def get_repeat_device(bases: torch.Tensor, lengths: torch.Tensor,
                      thresh_early: torch.Tensor, thresh_prop: torch.Tensor):
    """Plain tensor detector. bases [B, L] uint8 ASCII, lengths [B] int32,
    thresh_* [B, 5] int32 (host float64 floors).

    Returns (unit_ascii [B, 6] uint8, unit_len [B] int32, count [B] int32).
    """
    B, L = bases.shape
    dev = bases.device
    lengths = lengths.to(torch.int32)
    thresh_early = thresh_early.to(torch.int32)
    thresh_prop = thresh_prop.to(torch.int32)
    codes = (bases.to(torch.int32) >> 1) & 3
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    in_read = pos < lengths[:, None]
    skip = ((bases == ord("N")) & in_read).sum(dim=1) > 20  # utils.nim:238

    kmer_counts, exact_counts, kmer_ascii_by_k = [], [], []
    for k in KS:
        wmin, valid = _window_min_rotation(codes, lengths, k)
        if (1 << (2 * k)) < wmin.shape[1]:
            code, cnt = _modal_code_by_value(wmin, valid, k)
        else:
            code, cnt = _modal_code(wmin, valid)
        ka = _decode_ascii(code, k)
        kmer_counts.append(cnt)
        exact_counts.append(_exact_count(bases, lengths, ka, k))
        kmer_ascii_by_k.append(ka)

    # k-selection state machine (utils.nim:243-269)
    best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    res_ki = torch.full((B,), -1, dtype=torch.int32, device=dev)
    res_count = torch.zeros(B, dtype=torch.int32, device=dev)
    for ki, k in enumerate(KS):
        cnt = kmer_counts[ki]
        ex = exact_counts[ki]
        gate1_fail = cnt * k <= best
        newly_done = ~done & gate1_fail & (cnt < thresh_early[:, ki])
        proceed = ~done & ~gate1_fail
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

    # homopolymer reduction (utils.nim:220-233,271)
    is_homo = res_ki >= 0
    for i in range(1, 6):
        is_homo = is_homo & ((i >= unit_len) | (unit[:, i] == unit[:, 0]))
    res_count = res_count * torch.where(is_homo, unit_len, 1)
    unit_len = torch.where(is_homo, unit_len.clamp(max=1), unit_len)
    col = torch.arange(6, device=dev)[None, :]
    unit = torch.where(col < unit_len[:, None], unit, 0)

    # N-heavy reads produce nothing (utils.nim:238)
    res_count = torch.where(skip, 0, res_count)
    unit = torch.where(skip[:, None], 0, unit)
    unit_len = torch.where(skip, 0, unit_len)
    return unit, unit_len, res_count


def unpack_ascii(packed: torch.Tensor, nbits: torch.Tensor | None):
    """Inverse of pack_bases. nbits None means the batch is N-free (n8)."""
    B, L4 = packed.shape
    shifts = torch.arange(4, dtype=torch.int32, device=packed.device) * 2
    d = ((packed[:, :, None].to(torch.int32) >> shifts) & 3).reshape(B, L4 * 4)
    a = 65 + 2 * d + 15 * (d == 2).to(torch.int32)  # A/C/T/G ASCII
    if nbits is None:
        return a.to(torch.uint8)
    bit = torch.arange(8, dtype=torch.int32, device=packed.device)
    nm = ((nbits[:, :, None].to(torch.int32) >> bit) & 1).reshape(B, -1)
    return torch.where(nm[:, : L4 * 4] == 1, ord("N"), a).to(torch.uint8)


def _meta_from_payload(payload: torch.Tensor, meta_off: int, meta_w: int):
    """(lengths [R], te [R, 5], tp [R, 5]) from a payload's trailing meta."""
    meta = payload[:, meta_off:].to(torch.int32)
    if meta_w == FUSE_META16:
        meta = meta[:, 0::2] | (meta[:, 1::2] << 8)  # u16 little-endian
    return meta[:, 10], meta[:, :5], meta[:, 5:10]


def unfuse_payload(payload: torch.Tensor, layout: str):
    """Inverse of fuse_payload: (bases ASCII [R, L], lengths, te, tp).
    `layout` must be the one the producer reported."""
    L, meta_off, meta_w = payload_geometry(payload.shape[1], layout)
    pb = payload[:, : L // 4]
    nb = None if layout == "n8" else payload[:, L // 4: 3 * L // 8]
    lengths, te, tp = _meta_from_payload(payload, meta_off, meta_w)
    return unpack_ascii(pb, nb), lengths, te, tp


def _unit_to_code_device(unit: torch.Tensor, unit_len: torch.Tensor):
    """[B, 6] ASCII + len -> base-4 packed int32 code."""
    code = torch.zeros(unit.shape[0], dtype=torch.int32, device=unit.device)
    for i in range(6):
        digit = (unit[:, i].to(torch.int32) >> 1) & 3
        code = torch.where(i < unit_len, code * 4 + digit, code)
    return code


def repeat_codes_plain(x: torch.Tensor, layout: str, lengths=None, te=None,
                       tp=None):
    """Plain form of the kernel's contract: fused payload rows (`layout` in
    n8/w8/w16) or ASCII rows (`layout` "ascii" with lengths/te/tp) ->
    (code, len, count) int32 tensors."""
    if layout == "ascii":
        bases = x
    else:
        bases, lengths, te, tp = unfuse_payload(x, layout)
    unit, ulen, cnt = get_repeat_device(bases, lengths, te, tp)
    return _unit_to_code_device(unit, ulen), ulen, cnt


# --------------------------------------------------------------- dispatch
# Each entry takes an explicit device: a CPU device runs the plain form, a
# CUDA device the hand-written kernel (the choice is made by the wrapper,
# ops/kmer_cuda.repeat_scan, from the tensor's device).

_staging = threading.local()


def _pinned(name: str, nbytes: int) -> torch.Tensor:
    """Per-thread pinned host buffer of at least `nbytes`, reused across
    calls (pinning is far slower than the copy it enables)."""
    buf = getattr(_staging, name, None)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                          pin_memory=True)
        setattr(_staging, name, buf)
    return buf


def _stream(device: torch.device):
    """Per-thread CUDA stream, so concurrent callers each keep one batch in
    flight on their own stream."""
    streams = getattr(_staging, "streams", None)
    if streams is None:
        streams = _staging.streams = {}
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in streams:
        streams[key] = torch.cuda.Stream(device=key)
    return streams[key]


def _scan_on(device: torch.device, host_arrays, layout: str):
    """Stage numpy inputs onto `device`, run the scan, return numpy
    (code, len, count). Blocking; thread-safe."""
    from strling_tpu_torch.ops.kmer_cuda import repeat_scan

    if device.type != "cuda":
        ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in host_arrays]
        return tuple(t.numpy() for t in repeat_scan(ts[0], layout, *ts[1:]))
    n = len(host_arrays[0])
    total = sum(a.nbytes for a in host_arrays)
    pin_in = _pinned("pin_in", total)
    pin_out = _pinned("pin_out", 12 * n)
    stream = _stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        dev_in, off = [], 0
        for a in host_arrays:
            a = np.ascontiguousarray(a)
            view = pin_in[off: off + a.nbytes]
            view.numpy()[:] = a.reshape(-1).view(np.uint8)
            t = view.to(device, non_blocking=True).view(
                torch.from_numpy(a[:0]).dtype).reshape(a.shape)
            dev_in.append(t)
            off += a.nbytes
        outs = repeat_scan(dev_in[0], layout, *dev_in[1:])
        host_out = pin_out[: 12 * n].view(torch.int32).reshape(3, n)
        for i, o in enumerate(outs):
            host_out[i].copy_(o, non_blocking=True)
    stream.synchronize()
    res = host_out.numpy().copy()
    return res[0], res[1], res[2]


def scan_payload(payload: np.ndarray, n_rows: int, layout: str, device):
    """Scan the first `n_rows` rows of a fused payload (e.g. from the C++
    engine's sio_ex_next_fused) on `device`; returns numpy int32 (code, len,
    count). Blocking and thread-safe: the pipelined extract calls it from
    worker threads so transfers and scans of in-flight batches overlap."""
    if n_rows == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    return _scan_on(torch.device(device), [payload[:n_rows]], layout)


def _scan_ascii(bases, lengths, props, device):
    te, tp = _host_thresholds(lengths, props)
    return _scan_on(torch.device(device),
                    [np.ascontiguousarray(bases, np.uint8),
                     np.asarray(lengths, np.int32), te, tp], "ascii")


def scan_codes(bases: np.ndarray, lengths: np.ndarray, props: np.ndarray,
               device):
    """Detect repeat units of [B, L] ASCII rows on `device`; returns numpy
    int32 (code, len, count). ACGTN-only batches travel as a fused 2-bit
    payload; others (IUPAC bytes, L%8) take the kernel's ASCII entry."""
    lengths = np.asarray(lengths, np.int32)
    props = np.asarray(props, np.float64)
    if len(lengths) == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    payload, layout = fuse_payload(bases, lengths, props, return_layout=True)
    if payload is not None:
        return scan_payload(payload, len(payload), layout, device)
    return _scan_ascii(bases, lengths, props, device)


def get_repeat_batch(bases: np.ndarray, lengths: np.ndarray,
                     proportion_repeat, device):
    """Detect repeat units for a batch of reads through the ASCII entry.

    Returns (unit uint8 [B, 6] ASCII zero-padded, unit_len int32 [B],
    repeat_count int32 [B]) as numpy arrays.
    """
    lengths = np.asarray(lengths, np.int32)
    props = np.asarray(proportion_repeat, np.float64)
    if props.ndim == 0:
        props = np.full(len(lengths), float(props))
    code, ulen, cnt = _scan_ascii(bases, lengths, props, device)
    return codes_to_ascii(code, ulen), ulen, cnt
