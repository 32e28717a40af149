"""FLAC codec (host): decoder and encoder.
Port of openeat_tpu/dataset/flac.py, a copy kept here so that the port
needs nothing of the JAX package. It reads LibriSpeech's distributed
.flac files directly (RFC 9639, no libFLAC).

Decoder: 8/16/20/24/32-bit, 1-8 channels, fixed and variable blocking,
every subframe type (CONSTANT, VERBATIM, FIXED 0-4, LPC 1-32), wasted
bits, RICE and RICE2 residual partitions with raw-escape codes, every
stereo decorrelation (left/side, right/side, mid/side), the CRC-8 header
and CRC-16 frame checks, and the STREAMINFO MD5 of the decoded PCM.

Encoder (test fixtures, data preparation): 8/16/24-bit, any channel
count, constant / verbatim / fixed subframes with single-partition rice
coding, optional left/side stereo, correct CRCs and MD5.

The C++ decoder of native/openeat_io.cc (openeat_torch/runtime/
native_io.py) reads batches on a thread pool; this module is the
reader without it and the oracle it is held to.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

# ---------------------------------------------------------------------------
# CRCs (FLAC uses CRC-8 poly 0x07 and CRC-16 poly 0x8005, both init 0,
# MSB-first, no final xor)


def _make_crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, np.uint32)
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if (crc & top) else (crc << 1)
        table[b] = crc & mask
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ int(_CRC16_TABLE[(crc >> 8) ^ b])
    return crc


# ---------------------------------------------------------------------------
# Bit IO


class _Bits:
    """MSB-first bit reader over bytes, with fast unary via 1-bit index."""

    def __init__(self, data: bytes):
        self._bytes = data
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.ones = np.flatnonzero(self.bits)
        self.pos = 0
        # weights for read(); max field width is 36 bits (utf8 numbers
        # are read byte-wise, so 32 covers every other field)
        self._w = (1 << np.arange(31, -1, -1)).astype(np.int64)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        chunk = self.bits[p:p + n]
        if len(chunk) < n:
            raise EOFError("flac: truncated stream")
        return int(chunk @ self._w[32 - n:])

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if n and (v >> (n - 1)) else v

    def read_unary(self) -> int:
        """Number of 0 bits before the next 1 bit (which is consumed)."""
        i = np.searchsorted(self.ones, self.pos)
        if i >= len(self.ones):
            raise EOFError("flac: truncated stream (unary)")
        t = int(self.ones[i])
        q = t - self.pos
        self.pos = t + 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def byte_pos(self) -> int:
        return self.pos >> 3

    def at_end(self) -> bool:
        return self.pos >= len(self.bits)


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self._acc = 0
        self._n = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        self._acc = (self._acc << n) | (value & ((1 << n) - 1))
        self._n += n
        while self._n >= 8:
            self._n -= 8
            self.buf.append((self._acc >> self._n) & 0xFF)
        self._acc &= (1 << self._n) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self._n:
            self.write(0, 8 - self._n)

    def getvalue(self) -> bytes:
        assert self._n == 0, "unaligned"
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# Header tables

_BLOCKSIZE_CODES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                 6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _read_utf8_num(bits: _Bits) -> int:
    b0 = bits.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    while (b0 << n) & 0x80:
        n += 1
    if n < 2 or n > 7:
        raise ValueError("flac: bad utf8-coded number")
    val = b0 & (0x7F >> n)
    for _ in range(n - 1):
        c = bits.read(8)
        if c & 0xC0 != 0x80:
            raise ValueError("flac: bad utf8 continuation")
        val = (val << 6) | (c & 0x3F)
    return val


def _write_utf8_num(w: _BitWriter, val: int) -> None:
    if val < 0x80:
        w.write(val, 8)
        return
    # count 6-bit groups beyond the leading byte
    tails = []
    for n in range(1, 7):
        tails.insert(0, 0x80 | (val & 0x3F))
        val >>= 6
        lead_bits = 6 - n  # payload bits in the leading byte
        if val < (1 << lead_bits):
            lead = (0xFF << (lead_bits + 1)) & 0xFF | val
            w.write(lead, 8)
            for t in tails:
                w.write(t, 8)
            return
    raise ValueError("flac: number too large for utf8 coding")


# ---------------------------------------------------------------------------
# Decoder


def _decode_residual(bits: _Bits, blocksize: int, order: int) -> np.ndarray:
    method = bits.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual coding method")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    porder = bits.read(4)
    nparts = 1 << porder
    if blocksize % nparts or (blocksize >> porder) < order:
        raise ValueError("flac: bad residual partition order")
    out = np.empty(blocksize - order, np.int64)
    k_out = 0
    for p in range(nparts):
        count = (blocksize >> porder) - (order if p == 0 else 0)
        param = bits.read(pbits)
        if param == escape:
            raw = bits.read(5)
            for i in range(count):
                out[k_out + i] = bits.read_signed(raw) if raw else 0
        else:
            for i in range(count):
                q = bits.read_unary()
                u = (q << param) | bits.read(param)
                out[k_out + i] = (u >> 1) ^ -(u & 1)
        k_out += count
    return out


def _decode_subframe(bits: _Bits, blocksize: int, bps: int) -> np.ndarray:
    if bits.read(1):
        raise ValueError("flac: subframe padding bit set")
    t = bits.read(6)
    wasted = 0
    if bits.read(1):
        wasted = bits.read_unary() + 1
    bps -= wasted
    if t == 0:  # CONSTANT
        x = np.full(blocksize, bits.read_signed(bps), np.int64)
    elif t == 1:  # VERBATIM
        x = np.fromiter((bits.read_signed(bps) for _ in range(blocksize)),
                        np.int64, blocksize)
    elif 8 <= t <= 12:  # FIXED order 0-4
        order = t & 7
        warm = [bits.read_signed(bps) for _ in range(order)]
        res = _decode_residual(bits, blocksize, order)
        x = np.empty(blocksize, np.int64)
        x[:order] = warm
        if order == 0:
            x = res
        else:
            # o-th difference integration: y_{o-1} = d_{o-1}[-1]+cumsum(y_o)
            y = res
            w = np.asarray(warm, np.int64)
            for o in range(order - 1, -1, -1):
                y = np.diff(w, o)[-1] + np.cumsum(y)
            x[order:] = y
    elif t >= 32:  # LPC
        order = (t & 31) + 1
        warm = [bits.read_signed(bps) for _ in range(order)]
        prec = bits.read(4) + 1
        if prec == 16:
            raise ValueError("flac: invalid lpc precision")
        shift = bits.read_signed(5)
        if shift < 0:
            raise ValueError("flac: negative lpc shift")
        coefs = [bits.read_signed(prec) for _ in range(order)]
        res = _decode_residual(bits, blocksize, order)
        hist = list(warm)
        res_l = res.tolist()
        for i in range(len(res_l)):
            pred = 0
            for j, c in enumerate(coefs):
                pred += c * hist[-1 - j]
            hist.append(res_l[i] + (pred >> shift))
        x = np.asarray(hist, np.int64)
    else:
        raise ValueError(f"flac: reserved subframe type {t}")
    if wasted:
        x = x << wasted
    return x


def decode_flac(data: bytes, verify_md5: bool = True
                ) -> tuple[np.ndarray, int, int]:
    """bytes -> ([n, channels] int32 samples, sample_rate, bits_per_sample).

    Verifies every frame's CRC-8 + CRC-16 and (when present) the
    STREAMINFO MD5 of the decoded PCM.
    """
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    info = None
    while True:
        hdr = data[pos:pos + 4]
        if len(hdr) < 4:
            raise ValueError("flac: truncated metadata")
        last, btype = hdr[0] >> 7, hdr[0] & 0x7F
        blen = int.from_bytes(hdr[1:4], "big")
        if btype == 0:  # STREAMINFO
            si = data[pos + 4:pos + 4 + blen]
            rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4)
            nch = ((si[12] >> 1) & 0x7) + 1
            bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1
            total = ((si[13] & 0x0F) << 32) | int.from_bytes(si[14:18],
                                                             "big")
            md5 = si[18:34]
            info = dict(rate=rate, nch=nch, bps=bps, total=total, md5=md5)
        pos += 4 + blen
        if last:
            break
    if info is None:
        raise ValueError("flac: no STREAMINFO block")

    bits = _Bits(data[pos:])
    chans: list[np.ndarray] = []
    while not bits.at_end():
        start_byte = bits.byte_pos
        if len(bits.bits) - bits.pos < 16:  # trailing sub-frame-size bytes
            break
        sync = bits.read(14)
        if sync != 0x3FFE:
            raise ValueError(f"flac: lost frame sync at byte {start_byte}")
        bits.read(1)  # reserved
        bits.read(1)  # blocking strategy (number read below either way)
        bs_code = bits.read(4)
        sr_code = bits.read(4)
        ch_code = bits.read(4)
        ss_code = bits.read(3)
        bits.read(1)  # reserved
        _read_utf8_num(bits)  # frame/sample number
        if bs_code == 0:
            raise ValueError("flac: reserved blocksize code")
        elif bs_code == 6:
            blocksize = bits.read(8) + 1
        elif bs_code == 7:
            blocksize = bits.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_CODES[bs_code]
        if sr_code == 0:
            rate = info["rate"]
        elif sr_code == 12:
            rate = bits.read(8) * 1000
        elif sr_code == 13:
            rate = bits.read(16)
        elif sr_code == 14:
            rate = bits.read(16) * 10
        elif sr_code == 15:
            raise ValueError("flac: invalid sample-rate code")
        else:
            rate = _SAMPLE_RATES[sr_code]
        bps = info["bps"] if ss_code == 0 else _SAMPLE_SIZES[ss_code]
        hdr_bytes = data[pos + start_byte:pos + bits.byte_pos]
        if crc8(hdr_bytes) != bits.read(8):
            raise ValueError("flac: frame header CRC-8 mismatch")

        if ch_code < 8:
            nch = ch_code + 1
            subs = [_decode_subframe(bits, blocksize, bps)
                    for _ in range(nch)]
        elif ch_code in (8, 9, 10):
            extra0 = 1 if ch_code == 9 else 0
            extra1 = 1 if ch_code in (8, 10) else 0
            s0 = _decode_subframe(bits, blocksize, bps + extra0)
            s1 = _decode_subframe(bits, blocksize, bps + extra1)
            if ch_code == 8:  # left/side
                subs = [s0, s0 - s1]
            elif ch_code == 9:  # right/side (ch0 = side, ch1 = right)
                subs = [s1 + s0, s1]
            else:  # mid/side
                mid2 = (s0 << 1) | (s1 & 1)
                subs = [(mid2 + s1) >> 1, (mid2 - s1) >> 1]
        else:
            raise ValueError("flac: reserved channel assignment")
        bits.align()
        frame_bytes = data[pos + start_byte:pos + bits.byte_pos]
        if crc16(frame_bytes) != bits.read(16):
            raise ValueError("flac: frame CRC-16 mismatch")
        chans.append(np.stack(subs, axis=1))

    if not chans:
        raise ValueError("flac: no frames")
    out = np.concatenate(chans, axis=0)
    if info["total"]:
        out = out[: info["total"]]
    if verify_md5 and info["md5"] != b"\x00" * 16:
        nbytes = (info["bps"] + 7) // 8
        raw = _pack_pcm_le(out, info["bps"], nbytes)
        if hashlib.md5(raw).digest() != info["md5"]:
            raise ValueError("flac: decoded PCM fails STREAMINFO MD5")
    return out.astype(np.int32), info["rate"], info["bps"]


def _pack_pcm_le(samples: np.ndarray, bps: int, nbytes: int) -> bytes:
    """Interleaved little-endian signed PCM (the MD5 input per spec)."""
    flat = samples.reshape(-1).astype(np.int64)
    b = np.empty((len(flat), nbytes), np.uint8)
    for i in range(nbytes):
        b[:, i] = (flat >> (8 * i)) & 0xFF
    return b.tobytes()


def read_flac(path: str, start_s: float | None = None,
              end_s: float | None = None) -> tuple[np.ndarray, int]:
    """FLAC -> (mono float32 in [-1,1], rate); read_wav semantics
    (channel averaging, [start_s, end_s) slicing)."""
    with open(path, "rb") as f:
        data = f.read()
    samples, rate, bps = decode_flac(data)
    x = samples.astype(np.float32) / float(1 << (bps - 1))
    if x.shape[1] > 1:
        x = x.mean(axis=1)
    else:
        x = x[:, 0]
    if start_s is not None or end_s is not None:
        s = int((start_s or 0.0) * rate)
        e = int(end_s * rate) if end_s is not None else len(x)
        x = x[s:e]
    return np.ascontiguousarray(x), rate


# ---------------------------------------------------------------------------
# Encoder


def _best_fixed_order(x: np.ndarray, max_order: int = 4) -> int:
    best, best_cost = 0, None
    d = x.astype(np.int64)
    for o in range(max_order + 1):
        if o > 0:
            d = np.diff(d)
        if len(d) == 0:
            break
        cost = np.abs(d).sum()
        if best_cost is None or cost < best_cost:
            best, best_cost = o, cost
    return best


def _rice_param(res: np.ndarray, pbits: int) -> int:
    if len(res) == 0:
        return 0
    mean = max(float(np.abs(res).mean()), 0.25)
    k = max(0, int(np.ceil(np.log2(mean + 1))))
    return min(k, (1 << pbits) - 2)


def _encode_residual(w: _BitWriter, res: np.ndarray) -> None:
    w.write(0, 2)   # rice, 4-bit params
    w.write(0, 4)   # partition order 0
    k = _rice_param(res, 4)
    res64 = res.astype(np.int64)
    u = (np.abs(res64) << 1) - (res64 < 0).astype(np.int64)
    rice_cost = int((u >> k).sum()) + len(res) * (k + 1)
    raw_bits = (int(np.abs(res64).max()).bit_length() + 1
                if len(res) and np.any(res64) else 1)
    if rice_cost > len(res) * raw_bits + 5:
        # pathological residuals: raw-escape partition
        w.write(0xF, 4)
        w.write(raw_bits, 5)
        for v in res64.tolist():
            w.write(int(v), raw_bits)
        return
    w.write(k, 4)
    for ui in u.tolist():
        w.write_unary(ui >> k)
        w.write(ui, k)


def _encode_subframe(w: _BitWriter, x: np.ndarray, bps: int) -> None:
    w.write(0, 1)  # pad
    if np.all(x == x[0]):
        w.write(0, 6)   # CONSTANT
        w.write(0, 1)   # no wasted bits
        w.write(int(x[0]), bps)
        return
    order = _best_fixed_order(x)
    res = np.diff(x.astype(np.int64), order) if order else x.astype(np.int64)
    # verbatim fallback if rice coding won't help
    if int(np.abs(res).max()).bit_length() + 2 >= bps and order == 0:
        w.write(1, 6)   # VERBATIM
        w.write(0, 1)
        for v in x.tolist():
            w.write(int(v), bps)
        return
    w.write(8 | order, 6)  # FIXED
    w.write(0, 1)
    for v in x[:order].tolist():
        w.write(int(v), bps)
    _encode_residual(w, res)


def encode_flac(samples: np.ndarray, rate: int, bps: int = 16,
                block_size: int = 4096, left_side: bool = False) -> bytes:
    """[n, channels] int samples -> FLAC bytes (fixed blocking).

    left_side=True uses left/side decorrelation for 2-channel input
    (exercises the decoder's stereo modes in tests)."""
    samples = np.atleast_2d(np.asarray(samples, np.int64))
    if samples.shape[0] < samples.shape[1]:
        raise ValueError("expected [n, channels]")
    n, nch = samples.shape
    assert 1 <= nch <= 8
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    if samples.min() < lo or samples.max() > hi:
        raise ValueError(f"samples exceed {bps}-bit range")

    out = bytearray(b"fLaC")
    si = bytearray(34)
    struct.pack_into(">HH", si, 0, min(block_size, n or 1),
                     min(block_size, n or 1))
    # min/max framesize unknown -> 0
    si[10] = (rate >> 12) & 0xFF
    si[11] = (rate >> 4) & 0xFF
    si[12] = ((rate & 0xF) << 4) | ((nch - 1) << 1) | ((bps - 1) >> 4)
    si[13] = (((bps - 1) & 0xF) << 4) | ((n >> 32) & 0xF)
    si[14:18] = (n & 0xFFFFFFFF).to_bytes(4, "big")
    si[18:34] = hashlib.md5(_pack_pcm_le(samples, bps,
                                         (bps + 7) // 8)).digest()
    out += bytes([0x80]) + len(si).to_bytes(3, "big") + si

    sr_code = {v: k for k, v in _SAMPLE_RATES.items()}.get(rate)
    ss_code = {v: k for k, v in _SAMPLE_SIZES.items()}[bps]
    frame_no = 0
    for off in range(0, n, block_size):
        blk = samples[off:off + block_size]
        bsz = blk.shape[0]
        w = _BitWriter()
        w.write(0x3FFE, 14)
        w.write(0, 1)   # reserved
        w.write(0, 1)   # fixed blocking
        w.write(7, 4)   # blocksize: 16-bit explicit
        w.write(sr_code if sr_code is not None else 13, 4)
        use_ls = left_side and nch == 2
        w.write(8 if use_ls else nch - 1, 4)
        w.write(ss_code, 3)
        w.write(0, 1)   # reserved
        _write_utf8_num(w, frame_no)
        w.write(bsz - 1, 16)
        if sr_code is None:
            w.write(rate, 16)
        hdr = bytes(w.buf)  # byte-aligned here by construction
        assert w._n == 0
        w.write(crc8(hdr), 8)
        if use_ls:
            left = blk[:, 0]
            side = blk[:, 0] - blk[:, 1]
            _encode_subframe(w, left, bps)
            _encode_subframe(w, side, bps + 1)
        else:
            for c in range(nch):
                _encode_subframe(w, blk[:, c], bps)
        w.align()
        frame = w.getvalue()
        out += frame + crc16(frame).to_bytes(2, "big")
        frame_no += 1
    return bytes(out)


def write_flac(path: str, x: np.ndarray, rate: int, bps: int = 16) -> None:
    """Write mono float32 [-1,1] (write_wav twin)."""
    top = float(1 << (bps - 1))
    # truncation toward zero — identical quantization to write_wav so a
    # FLAC+WAV pair of the same float audio decodes bit-equal
    pcm = np.clip(x * top, -top, top - 1).astype(np.int64)
    with open(path, "wb") as f:
        f.write(encode_flac(pcm[:, None], rate, bps=bps))
