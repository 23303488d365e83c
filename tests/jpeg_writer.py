"""A test-only JPEG writer for what Pillow does not write: any sampling
factors from 1 to 4 a component, any component ids, JFIF and Adobe
markers at will, restart intervals, one scan a component (sequential,
non-interleaved), and progressive files of spectral selection alone (an
interleaved DC scan, then one scan a component and band of AC
coefficients; `scan_offsets` finds the scans, to drop some). Huffman
coding, 8-bit samples.

Its output is only ever held to Pillow's decode of the same bytes, so
the encoder need not be a good one: a float DCT, two fixed quantization
tables and flat Huffman tables (every DC category a 4-bit code, every AC
symbol an 8-bit code).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# quantization tables in natural order: a luma-like and a chroma-like ramp
_U, _V = np.meshgrid(np.arange(8), np.arange(8))
QUANT = [(3 + 2 * (_U + _V)).reshape(-1), (5 + 3 * (_U + _V)).reshape(-1)]

DC_SYMBOLS = list(range(12))
AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | s for r in range(16)
                             for s in range(1, 11)]

_C = np.array([[np.cos((2 * x + 1) * u * np.pi / 16) *
                (np.sqrt(0.125) if u == 0 else 0.5)
                for x in range(8)] for u in range(8)])


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, bits: int) -> None:
        for i in range(bits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> Tuple[int, int]:
    """(size, bits) of a coefficient value."""
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _blocks(plane: np.ndarray, qt: np.ndarray, bw: int, bh: int):
    """The plane padded by edge replication to bh x bw blocks, each
    DCT'd and quantized: [bh, bw, 64] in zigzag order."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - 128,
               ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    b = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ux,abxy,vy->abuv", _C, b, _C).reshape(bh, bw, 64)
    q = np.round(coef / qt).astype(np.int64)
    return q[..., ZIGZAG]


def encode_jpeg(planes: Sequence[np.ndarray],
                factors: Sequence[Tuple[int, int]],
                ids: Optional[Sequence[int]] = None, jfif: bool = True,
                adobe: Optional[int] = None, restart: int = 0,
                interleaved: bool = True,
                bands: Optional[Sequence[Tuple[int, int]]] = None) -> bytes:
    """planes: one uint8 [H, W] array a component at full size; each is
    decimated to its (h, v) factors. adobe: an Adobe APP14 marker with
    this transform, or none. restart: MCUs a restart interval (0: none).
    interleaved=False writes one scan a component. bands: a progressive
    (SOF2) file, the DC scan then these (Ss, Se) AC bands a component."""
    n = len(planes)
    height, width = planes[0].shape
    ids = list(ids) if ids is not None else list(range(1, n + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    tq = [0] + [1] * (n - 1)
    comp = []
    for plane, (h, v), q in zip(planes, factors, tq):
        cw, ch = -(-width * h // hmax), -(-height * v // vmax)
        ys = np.minimum(np.arange(ch) * vmax // v, height - 1)
        xs = np.minimum(np.arange(cw) * hmax // h, width - 1)
        small = plane[ys][:, xs]
        comp.append(dict(h=h, v=v, cw=cw, ch=ch, blocks=_blocks(
            small, QUANT[q], mcux * h, mcuy * v)))
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _marker(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" +
                       bytes([adobe]))
    for t in range(2 if n > 1 else 1):
        out += _marker(0xDB, bytes([t]) +
                       bytes(QUANT[t][ZIGZAG].astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, height, width, n)
    for cid, (h, v), q in zip(ids, factors, tq):
        sof += bytes([cid, h << 4 | v, q])
    out += _marker(0xC2 if bands else 0xC0, sof)
    dc_counts = [0] * 16
    dc_counts[3] = len(DC_SYMBOLS)
    ac_counts = [0] * 16
    ac_counts[7] = len(AC_SYMBOLS)
    out += _marker(0xC4, bytes([0x00] + dc_counts + DC_SYMBOLS) +
                   bytes([0x10] + ac_counts + AC_SYMBOLS))
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))
    dc_code = {s: i for i, s in enumerate(DC_SYMBOLS)}
    ac_code = {s: i for i, s in enumerate(AC_SYMBOLS)}
    if bands:
        scans = [(list(range(n)), 0, 0)] + [([c], ss, se) for c in range(n)
                                            for ss, se in bands]
    else:
        scans = [(list(range(n)), 0, 63)] if interleaved else [
            ([c], 0, 63) for c in range(n)]
    for scan, ss, se in scans:
        body = bytes([len(scan)])
        for c in scan:
            body += bytes([ids[c], 0x00])
        out += _marker(0xDA, body + bytes([ss, se, 0]))
        out += _scan_data(comp, scan, mcux, mcuy, restart, dc_code,
                          ac_code, ss, se)
    out += b"\xff\xd9"
    return bytes(out)


def scan_offsets(data: bytes) -> List[int]:
    """The offset of each SOS marker of a JPEG file, in order."""
    out, i = [], 2
    while i + 4 <= len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF) or \
                0xD0 <= data[i + 1] <= 0xD7:
            i += 1
            continue
        if data[i + 1] == 0xD9:
            break
        if data[i + 1] == 0xDA:
            out.append(i)
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return out


def _scan_data(comp, scan: List[int], mcux: int, mcuy: int, restart: int,
               dc_code, ac_code, ss: int = 0, se: int = 63) -> bytes:
    order = []  # (component, block row, block column) in decode order
    if len(scan) == 1:
        c = comp[scan[0]]
        for by in range(-(-c["ch"] // 8)):
            for bx in range(-(-c["cw"] // 8)):
                order.append([(scan[0], by, bx)])
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                mcu = []
                for ci in scan:
                    c = comp[ci]
                    for y in range(c["v"]):
                        for x in range(c["h"]):
                            mcu.append((ci, my * c["v"] + y,
                                        mx * c["h"] + x))
                order.append(mcu)
    out = bytearray()
    bits = _BitWriter()
    pred = {}
    for m, mcu in enumerate(order):
        if restart and m and m % restart == 0:
            bits.flush()
            out += bits.out + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            bits = _BitWriter()
            pred = {}
        for ci, by, bx in mcu:
            blk = comp[ci]["blocks"][by, bx]
            if ss == 0:
                diff = int(blk[0]) - pred.get(ci, 0)
                pred[ci] = int(blk[0])
                s, v = _category(diff)
                bits.put(dc_code[s], 4)
                bits.put(v, s)
                if se == 0:
                    continue
            first = max(ss, 1)
            run = 0
            last = max([k for k in range(first, se + 1) if blk[k]],
                       default=first - 1)
            for k in range(first, last + 1):
                if blk[k] == 0:
                    run += 1
                    continue
                while run > 15:
                    bits.put(ac_code[0xF0], 8)
                    run -= 16
                s, v = _category(int(blk[k]))
                bits.put(ac_code[run << 4 | s], 8)
                bits.put(v, s)
                run = 0
            if last < se:
                bits.put(ac_code[0x00], 8)
    bits.flush()
    out += bits.out
    return bytes(out)
