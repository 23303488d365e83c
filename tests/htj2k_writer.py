"""A test-only HTJ2K writer (ISO 15444-15: JPEG 2000 with the
High-Throughput block coder), numpy only, so that the port's scripts may
use it where Pillow is absent.

It writes raw J2C codestreams and JPH files (a JP2 file of brand `jph `):
SIZ with Rsiz 0x4000, a CAP marker (Part 15), optionally CPF; reversible
5/3 with RCT or irreversible 9/7 with ICT and QCD step sizes; 0 to 5
decomposition levels; code-blocks of any size the standard allows (64x64,
32x32, 16x16, 128x16, ...); precincts; tiles; one or several quality
layers in LRCP, RLCP or RPCL order; SOP and EPH markers. Each code-block is
an HT cleanup pass (its MEL, VLC and MagSgn streams, Scup in its last two
bytes), and where asked and possible an HT refinement segment (SigProp,
then MagRef written backwards from its end).

The VLC codewords are read off csrc/htj2k_tables.h (OpenJPEG 2.5.4's
decoding tables, inverted: each (context, rho, u_off, e_k, e_1) tuple's
codeword is the low bits of an index that decodes to it) and chosen as
OpenJPH's encoder chooses them (the widest e_k an exponent pattern
allows). The MEL, VLC and MagSgn termination follows OpenJPH; the
refinement passes follow the scan order OpenJPEG's ht_dec.c decodes:
stripes of four rows, significance propagated forward within a stripe,
to the next stripe's top row, and (unless the code-block style sets VSC)
from the next stripe's top row.

`encode(image, ...)` returns the codestream; `jph_file` wraps one. A
lossless layout (reversible, every refinement lossless) decodes to the
image it was written from: the refinement passes are used only in a
code-block whose every magnitude-1 sample the SigProp pass reaches
(`refine="lossless"`), else that block is cleanup only; `refine="all"`
refines every block with a significant sample at the cleanup plane,
losing what SigProp does not reach.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

TABLES = (Path(__file__).resolve().parent.parent / "maskrcnn_tpu_torch"
          / "csrc" / "htj2k_tables.h")
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2}
# code-block style bits (COD's SPcod): HT is 0x40
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM, HT = 1, 2, 4, 8, 16, 32, 64

_TABLES = None


def vlc_tables():
    """(vlc_tbl0, vlc_tbl1) from csrc/htj2k_tables.h, uint16 [1024] each."""
    global _TABLES
    if _TABLES is None:
        text = TABLES.read_text()
        out = []
        for name in ("kHtVlcTable0", "kHtVlcTable1"):
            body = re.search(name + r"\[1024\] = \{([^}]*)\}", text).group(1)
            t = np.array([int(v, 16) for v in re.findall(r"0x[0-9a-f]+",
                                                         body)], np.int64)
            assert t.shape == (1024,), name
            out.append(t)
        _TABLES = (out, [_codewords(t) for t in out])
    return _TABLES[0]


def _codewords(table):
    """(c_q, rho, u_off) -> [(e_k, e_1, codeword, length)] of a decoding
    table: each tuple's codeword is the low `length` bits of an index."""
    found = {}
    for index in range(1024):
        v = int(table[index])
        length = v & 7
        key = (index >> 7, (v >> 4) & 15, (v >> 3) & 1)
        entry = ((v >> 12) & 15, (v >> 8) & 15, index & ((1 << length) - 1),
                 length)
        if entry not in found.setdefault(key, []):
            found[key].append(entry)
    return found


def _codeword(initial: bool, c_q: int, rho: int, u_off: int, emb: int):
    """(e_k, codeword, length) for a quad, as OpenJPH's encoder tables
    pick it: u_off 0 takes the first entry; u_off 1 the entry with the most
    e_k bits whose e_1 equals the exponent pattern on e_k."""
    vlc_tables()
    entries = _TABLES[1][0 if initial else 1][(c_q, rho, u_off)]
    if not u_off:
        e_k, _, cwd, length = entries[0]
        return e_k, cwd, length
    best = None
    for e_k, e_1, cwd, length in entries:
        if (emb & e_k) == e_1:
            if best is None or bin(e_k).count("1") >= bin(best[0]).count("1"):
                best = (e_k, cwd, length)
    assert best is not None, (initial, c_q, rho, emb)
    return best


# ------------------------------------------------------------ bit writers

class _Mel:
    """The MEL coder (OpenJPH's mel_encode): run lengths of zero events
    under a 13-state exponent table, bits MSB first, 7 after 0xFF."""
    EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)

    def __init__(self):
        self.out, self.tmp, self.remaining = [], 0, 8
        self.run, self.k, self.threshold = 0, 0, 1

    def bit(self, v: int) -> None:
        self.tmp = (self.tmp << 1) | v
        self.remaining -= 1
        if self.remaining == 0:
            self.out.append(self.tmp)
            self.remaining = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, one: bool) -> None:
        if not one:
            self.run += 1
            if self.run >= self.threshold:
                self.bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.threshold = 1 << self.EXP[self.k]
        else:
            self.bit(0)
            t = self.EXP[self.k]
            while t > 0:
                t -= 1
                self.bit((self.run >> t) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)
            self.threshold = 1 << self.EXP[self.k]


class _Backward:
    """A stream read backwards (VLC, MagRef): bits LSB first from the last
    byte down; a byte after one above 0x8F holds 7 bits where those are all
    ones (its MSB 0). The VLC's last byte is Scup's (0xFF until written)
    and its first nibble Scup's low bits."""

    def __init__(self, vlc: bool):
        if vlc:
            self.out, self.tmp, self.used = [0xFF], 0xF, 4
        else:
            self.out, self.tmp, self.used = [], 0, 0
        self.above_8f = True

    def put(self, cwd: int, n: int) -> None:
        while n > 0:
            avail = 8 - self.above_8f - self.used
            t = min(avail, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            n -= t
            cwd >>= t
            if avail == 0:
                if self.above_8f and self.tmp != 0x7F:
                    self.above_8f = False
                    continue
                self.out.append(self.tmp)
                self.above_8f = self.tmp > 0x8F
                self.tmp = self.used = 0

    def flush(self) -> bytes:
        """The stream in file order (the last byte written first)."""
        out = self.out + ([self.tmp] if self.used else [])
        return bytes(reversed(out))


class _Forward:
    """A stream read forwards (MagSgn, SigProp): bits LSB first, 7 in a
    byte after 0xFF (its MSB 0)."""

    def __init__(self):
        self.out, self.tmp, self.used, self.max = [], 0, 0, 8

    def put(self, cwd: int, n: int) -> None:
        while n > 0:
            t = min(self.max - self.used, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            cwd >>= t
            n -= t
            if self.used >= self.max:
                self.out.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp = self.used = 0

    def magsgn(self) -> bytes:
        """OpenJPH's ms_terminate: the last byte padded with ones, dropped
        where it is 0xFF (the decoder reads 0xFF past the end)."""
        out = list(self.out)
        if self.used:
            t = self.max - self.used
            tmp = self.tmp | ((0xFF & ((1 << t) - 1)) << self.used)
            if tmp != 0xFF:
                out.append(tmp)
        elif self.max == 7:
            out.pop()
        return bytes(out)

    def zeros(self) -> bytes:
        return bytes(self.out + ([self.tmp] if self.used else []))


def _terminate_mel_vlc(mel: _Mel, vlc: _Backward):
    """OpenJPH's terminate_mel_vlc: a pending MEL run ended by a 1, then
    the two partial bytes fused into one where their bits agree."""
    if mel.run > 0:
        mel.bit(1)
    mel.tmp = (mel.tmp << mel.remaining) & 0xFF
    mel_mask = (0xFF << mel.remaining) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used)
    if (mel_mask | vlc_mask) == 0:
        return
    fuse = mel.tmp | vlc.tmp
    if ((((fuse ^ mel.tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask)) == 0
            and fuse != 0xFF and len(vlc.out) > 1):
        mel.out.append(fuse)
    else:
        mel.out.append(mel.tmp)
        vlc.out.append(vlc.tmp)
    vlc.used = 0


# the UVLC prefix codewords (LSB first): u 1 "1", 2 "01", 3-4 "001" and a
# bit, 5-36 "000" and 5 bits
def _uvlc(u: int):
    """(prefix, prefix length, suffix, suffix length) of u >= 1."""
    assert 1 <= u <= 36, u
    if u == 1:
        return 1, 1, 0, 0
    if u == 2:
        return 2, 2, 0, 0
    if u <= 4:
        return 4, 3, u - 3, 1
    return 0, 3, u - 5, 5


def _exponent(mu: int) -> int:
    """E of a magnitude: the bit length of 2 mu - 1 (0 for 0)."""
    return (2 * mu - 1).bit_length() if mu else 0


# ------------------------------------------------------------ block coder

def cleanup_pass(mu: np.ndarray, sign: np.ndarray) -> bytes:
    """The HT cleanup segment of magnitudes `mu` (at the cleanup plane) and
    signs: MagSgn, then MEL, then the VLC backwards, Scup in the last 12
    bits."""
    h, w = mu.shape
    mu = [[int(v) for v in row] for row in mu]
    sign = [[int(v) for v in row] for row in sign]

    def m(y, x):
        return mu[y][x] if 0 <= y < h and 0 <= x < w else 0

    mel, vlc, ms = _Mel(), _Backward(True), _Forward()
    for y in range(0, h, 2):
        initial = y == 0
        carry = 0
        for x in range(0, w, 4):
            quads = []
            for cx in (x, x + 2):
                if cx >= w:
                    break
                pos = [(y, cx), (y + 1, cx), (y, cx + 1), (y + 1, cx + 1)]
                mus = [m(py, px) for py, px in pos]
                quads.append((cx, pos, mus))
            info = []
            for cx, pos, mus in quads:
                rho = sum((v > 0) << n for n, v in enumerate(mus))
                if initial:
                    c_q = carry
                else:
                    above = [m(y - 1, c) for c in range(cx - 1, cx + 3)]
                    c_q = (carry | (1 if above[0] or above[1] else 0)
                           | (4 if above[2] or above[3] else 0))
                es = [_exponent(v) for v in mus]
                kappa = 1
                if not initial and bin(rho).count("1") > 1:
                    e_up = max(_exponent(m(y - 1, c))
                               for c in range(cx - 1, cx + 3))
                    kappa = max(e_up - 1, 1)
                if rho:
                    u_q = max(max(es), kappa) - kappa
                else:
                    u_q = 0
                u_off = 1 if u_q > 0 else 0
                big = kappa + u_q
                emb = sum((e == big) << n for n, e in enumerate(es)
                          if u_off and mus[n])
                if c_q == 0:
                    mel.event(rho != 0)
                if c_q or rho:
                    e_k, cwd, length = _codeword(initial, c_q, rho, u_off, emb)
                    vlc.put(cwd, length)
                else:
                    e_k = 0
                if initial:
                    carry = ((rho & 1) | ((rho >> 1) & 1)
                             | (((rho >> 2) & 1) << 1)
                             | (((rho >> 3) & 1) << 2))
                else:
                    carry = 2 if rho & 12 else 0
                info.append((pos, mus, rho, u_q, u_off, big, e_k))
            # the u values
            u = [q[3] for q in info]
            offs = [q[4] for q in info] + [0]
            if offs[0] and offs[1]:
                if initial:
                    both = u[0] > 2 and u[1] > 2
                    mel.event(both)
                    if both:
                        a, b = _uvlc(u[0] - 2), _uvlc(u[1] - 2)
                        vlc.put(a[0], a[1])
                        vlc.put(b[0], b[1])
                        vlc.put(a[2], a[3])
                        vlc.put(b[2], b[3])
                    elif u[0] > 2:
                        a = _uvlc(u[0])
                        vlc.put(a[0], a[1])
                        vlc.put(u[1] - 1, 1)
                        vlc.put(a[2], a[3])
                    else:
                        a, b = _uvlc(u[0]), _uvlc(u[1])
                        vlc.put(a[0], a[1])
                        vlc.put(b[0], b[1])
                        vlc.put(a[2], a[3])
                        vlc.put(b[2], b[3])
                else:
                    a, b = _uvlc(u[0]), _uvlc(u[1])
                    vlc.put(a[0], a[1])
                    vlc.put(b[0], b[1])
                    vlc.put(a[2], a[3])
                    vlc.put(b[2], b[3])
            else:
                for k in range(len(info)):
                    if offs[k]:
                        a = _uvlc(u[k])
                        vlc.put(a[0], a[1])
                        vlc.put(a[2], a[3])
            # MagSgn: m_n = U_q - e_k bits of v_n = 2 (mu - 1) + sign
            for pos, mus, rho, u_q, u_off, big, e_k in info:
                for n, (py, px) in enumerate(pos):
                    if not mus[n]:
                        continue
                    m_n = big - ((e_k >> n) & 1)
                    v = 2 * (mus[n] - 1) + sign[py][px]
                    ms.put(v & ((1 << m_n) - 1), m_n)
    _terminate_mel_vlc(mel, vlc)
    tail = bytes(mel.out) + vlc.flush()
    scup = len(tail)
    assert 2 <= scup <= 4079, scup
    out = bytearray(ms.magsgn() + tail)
    out[-1] = scup >> 4
    out[-2] = (out[-2] & 0xF0) | (scup & 0xF)
    return bytes(out)


def _refine(mag: np.ndarray, sgn: np.ndarray, causal: bool, passes: int):
    """The HT refinement passes of quantized magnitudes `mag` and signs
    `sgn` whose cleanup coded plane 1 (its significance is mag >= 2):
    SigProp, then with `passes` 3 MagRef, in the order ht_dec.c decodes
    them. Returns (SigProp bytes, MagRef bytes in file order, lossless):
    lossless where every magnitude-1 sample was reached (the block then
    decodes to mag exactly with 3 passes)."""
    h, w = mag.shape
    cl = mag >= 2
    spp, mrp = _Forward(), _Backward(False)
    reached = np.zeros((h, w), bool)
    new = np.zeros((h, w), bool)
    for r0 in range(0, h, 4):
        r1 = min(r0 + 4, h)
        # the stripe's membership before its scan
        mbr = np.zeros((4, w + 2), bool)     # column c at c + 1

        def member(r, c):
            if cl[r, c]:
                return False
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    yy, xx = r + dy, c + dx
                    if not (0 <= xx < w) or not (0 <= yy < h):
                        continue
                    if r0 <= yy < r1 and cl[yy, xx]:
                        return True
                    if yy == r0 - 1 and (cl[yy, xx] or new[yy, xx]):
                        return True
                    if (yy == r0 + 4 and not causal and r == r0 + 3
                            and cl[yy, xx]):
                        return True
            return False

        for r in range(r0, r1):
            for c in range(w):
                mbr[r - r0, c + 1] = member(r, c)
        if passes >= 3:
            for c in range(w):
                for r in range(r0, r1):
                    if cl[r, c]:
                        mrp.put(int(mag[r, c]) & 1, 1)
        for g in range(0, w, 4):
            cols = range(g, min(g + 4, w))
            fresh = []
            for c in cols:
                for r in range(r0, r1):
                    if not mbr[r - r0, c + 1]:
                        continue
                    reached[r, c] = True
                    bit = 1 if mag[r, c] == 1 else 0
                    spp.put(bit, 1)
                    if bit:
                        new[r, c] = True
                        fresh.append((r, c))
                        for yy, xx in ((r + 1, c), (r - 1, c + 1), (r, c + 1),
                                       (r + 1, c + 1)):
                            if r0 <= yy < r1 and xx < w and not cl[yy, xx]:
                                mbr[yy - r0, xx + 1] = True
            for r, c in fresh:
                spp.put(int(sgn[r, c]), 1)
    lossless = bool(((mag != 1) | cl | reached).all())
    return spp.zeros(), (mrp.flush() if passes >= 3 else b""), lossless


def encode_block(q: np.ndarray, refine: Optional[str], causal: bool):
    """One code-block of signed quantized coefficients: (chunks, passes,
    plane), `chunks` the cleanup's bytes and, where refined, SigProp's and
    MagRef's (the refinement segment is their concatenation), `plane` the
    cleanup's bit-plane (0 or 1). None where the block is all zeros (never
    included). `refine`: None, or "lossless" / "all" with 3 passes,
    "sigprop" with 2."""
    mag = np.abs(q).astype(np.int64)
    sgn = (q < 0).astype(np.int64)
    if not mag.any():
        return None
    if refine and (mag >= 2).any():
        passes = 2 if refine == "sigprop" else 3
        spp, mrp, lossless = _refine(mag, sgn, causal, passes)
        if (lossless or refine != "lossless") and spp + mrp:
            return [cleanup_pass(mag >> 1, sgn), spp, mrp], passes, 1
    return [cleanup_pass(mag, sgn)], 1, 0


# ------------------------------------------------------------------ DWT

def _reflect(i: int, n: int) -> int:
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i = abs(i) % period
    return period - i if i >= n else i


def _fdwt53(x: np.ndarray, cas: int) -> np.ndarray:
    """The forward 5/3 of one line (low then high coefficients out), the
    inverse of OpenJPEG's opj_dwt_decode_1: `cas` the parity of its first
    coordinate."""
    n = len(x)
    if n == 1:
        return x * 2 if cas else x.copy()
    t = [int(v) for v in x]
    for i in range(1 - cas, n, 2):
        t[i] -= (t[_reflect(i - 1, n)] + t[_reflect(i + 1, n)]) >> 1
    for i in range(cas, n, 2):
        t[i] += (t[_reflect(i - 1, n)] + t[_reflect(i + 1, n)] + 2) >> 2
    return np.array(t[cas::2] + t[1 - cas::2], np.int64)


_ALPHA, _BETA, _GAMMA, _DELTA = (-1.586134342, -0.052980118, 0.882911075,
                                 0.443506852)
_K = 1.230174105


def _fdwt97(x: np.ndarray, cas: int) -> np.ndarray:
    """The forward 9/7 of one line in float64, the inverse of OpenJPEG's
    opj_v8dwt_decode (low scaled by 1/K, high by K/2)."""
    n = len(x)
    if n == 1:
        return x.astype(np.float64)
    t = x.astype(np.float64).copy()
    for coef, start in ((-_ALPHA, 1 - cas), (-_BETA, cas), (-_GAMMA, 1 - cas),
                        (-_DELTA, cas)):
        # (the decoder subtracts c times its neighbours; the forward adds)
        for i in range(start, n, 2):
            t[i] -= coef * (t[_reflect(i - 1, n)] + t[_reflect(i + 1, n)])
    low, high = t[cas::2] / _K, t[1 - cas::2] * (_K / 2)
    return np.concatenate([low, high])


def forward_dwt(a: np.ndarray, levels: int, x0: int, y0: int,
                real: bool) -> np.ndarray:
    """The tile-component's coefficients in OpenJPEG's layout (each level's
    LL at the top left), columns then rows at each level."""
    a = a.astype(np.float64 if real else np.int64).copy()
    h, w = a.shape
    line = _fdwt97 if real else _fdwt53
    for lev in range(levels):
        rx0, ry0 = -(-x0 // (1 << lev)), -(-y0 // (1 << lev))
        rx1 = -(-(x0 + w) // (1 << lev))
        ry1 = -(-(y0 + h) // (1 << lev))
        rw, rh = rx1 - rx0, ry1 - ry0
        if rw <= 0 or rh <= 0:
            continue
        for c in range(rw):
            a[:rh, c] = line(a[:rh, c], ry0 % 2)
        for r in range(rh):
            a[r, :rw] = line(a[r, :rw], rx0 % 2)
    return a


# ------------------------------------------------------------- geometry

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cdivp2(a: int, e: int) -> int:
    return -(-a >> e)


class _Block:
    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.segments, self.passes, self.plane = None, 0, 0
        self.layers = []        # (layer, passes, [segment lengths])
        self.lblock = 3
        self.included = False


class _Precinct:
    def __init__(self):
        self.blocks, self.cw, self.ch = [], 0, 0


def _tile_geometry(tx0, ty0, tx1, ty1, numres, cblk, prec):
    """OpenJPEG's tcd geometry of one tile-component (no subsampling):
    [resolution] -> (x0, y0, x1, y1, pw, ph, [band] -> (bandno, band
    rectangle, [precinct] -> _Precinct))."""
    out = []
    for r in range(numres):
        level = numres - 1 - r
        rx0, ry0 = _cdivp2(tx0, level), _cdivp2(ty0, level)
        rx1, ry1 = _cdivp2(tx1, level), _cdivp2(ty1, level)
        pdx, pdy = prec[r]
        tlx, tly = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        brx, bry = _cdivp2(rx1, pdx) << pdx, _cdivp2(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (brx - tlx) >> pdx
        ph = 0 if ry0 == ry1 else (bry - tly) >> pdy
        if r == 0:
            tlcx, tlcy, cbgw, cbgh = tlx, tly, pdx, pdy
            bands = [0]
        else:
            tlcx, tlcy = _cdivp2(tlx, 1), _cdivp2(tly, 1)
            cbgw, cbgh = pdx - 1, pdy - 1
            bands = [1, 2, 3]
        cbw, cbh = min(cblk[0], cbgw), min(cblk[1], cbgh)
        blist = []
        for bandno in bands:
            if r == 0:
                bx0, by0, bx1, by1 = (_cdivp2(tx0, level), _cdivp2(ty0, level),
                                      _cdivp2(tx1, level), _cdivp2(ty1, level))
            else:
                xob, yob = bandno & 1, bandno >> 1
                bx0 = _cdivp2(tx0 - (xob << level), level + 1)
                by0 = _cdivp2(ty0 - (yob << level), level + 1)
                bx1 = _cdivp2(tx1 - (xob << level), level + 1)
                by1 = _cdivp2(ty1 - (yob << level), level + 1)
            precincts = []
            for k in range(pw * ph):
                sx = tlcx + (k % pw) * (1 << cbgw)
                sy = tlcy + (k // pw) * (1 << cbgh)
                px0, py0 = max(sx, bx0), max(sy, by0)
                px1 = min(sx + (1 << cbgw), bx1)
                py1 = min(sy + (1 << cbgh), by1)
                pr = _Precinct()
                tbx, tby = (px0 >> cbw) << cbw, (py0 >> cbh) << cbh
                bbx, bby = _cdivp2(px1, cbw) << cbw, _cdivp2(py1, cbh) << cbh
                pr.cw = (bbx - tbx) >> cbw if bbx > tbx else 0
                pr.ch = (bby - tby) >> cbh if bby > tby else 0
                for j in range(pr.cw * pr.ch):
                    cx = tbx + (j % pr.cw) * (1 << cbw)
                    cy = tby + (j // pr.cw) * (1 << cbh)
                    pr.blocks.append(_Block(max(cx, px0), max(cy, py0),
                                            min(cx + (1 << cbw), px1),
                                            min(cy + (1 << cbh), py1)))
                pr.incl, pr.imsb = _TagTree(pr.cw, pr.ch), _TagTree(pr.cw,
                                                                     pr.ch)
                precincts.append(pr)
            blist.append((bandno, (bx0, by0, bx1, by1), precincts))
        out.append(((rx0, ry0, rx1, ry1), pw, ph, blist))
    return out


# -------------------------------------------------------------- tier 2

class _Bits:
    """Packet-header bits (bio.c): MSB first, a 0 stuffed after 0xFF."""

    def __init__(self):
        self.out, self.tmp, self.n, self.cap = bytearray(), 0, 0, 8

    def put(self, v: int, n: int = 1) -> None:
        for i in range(n - 1, -1, -1):
            self.tmp = (self.tmp << 1) | ((v >> i) & 1)
            self.n += 1
            if self.n == self.cap:
                self.out.append(self.tmp)
                self.cap = 7 if self.tmp == 0xFF else 8
                self.tmp = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.out.append(self.tmp << (self.cap - self.n))
            self.cap = 7 if self.out[-1] == 0xFF else 8
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTree:
    """tgt.c's tag tree for the encoder: values set at the leaves, minima
    above; each node's low and known state kept across packets."""

    def __init__(self, w: int, h: int):
        self.levels, lw, lh = [], w, h
        while True:
            self.levels.append((lw, lh))
            if lw * lh <= 1:
                break
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        self.value = [np.full((lh_, lw_), 999, np.int64)
                      for lw_, lh_ in self.levels]
        self.low = [np.zeros((lh_, lw_), np.int64) for lw_, lh_ in self.levels]
        self.known = [np.zeros((lh_, lw_), bool) for lw_, lh_ in self.levels]

    def set(self, k: int, v: int) -> None:
        w = self.levels[0][0]
        x, y = k % w, k // w
        for lev in range(len(self.levels)):
            if self.value[lev][y, x] > v:
                self.value[lev][y, x] = v
            x, y = x // 2, y // 2

    def encode(self, bits: _Bits, k: int, threshold: int) -> None:
        w = self.levels[0][0]
        x, y = k % w, k // w
        path = []
        for lev in range(len(self.levels)):
            path.append((lev, y, x))
            x, y = x // 2, y // 2
        low = 0
        for lev, y, x in reversed(path):
            if low > self.low[lev][y, x]:
                self.low[lev][y, x] = low
            else:
                low = self.low[lev][y, x]
            while low < threshold:
                if low >= self.value[lev][y, x]:
                    if not self.known[lev][y, x]:
                        bits.put(1)
                        self.known[lev][y, x] = True
                    break
                bits.put(0)
                low += 1
            self.low[lev][y, x] = low


def _numpasses(bits: _Bits, n: int) -> None:
    if n == 1:
        bits.put(0)
    elif n == 2:
        bits.put(0b10, 2)
    elif n <= 5:
        bits.put(0b1100 | (n - 3), 4)
    elif n <= 36:
        bits.put((0b1111 << 5) | (n - 6), 9)
    else:
        bits.put((0b111111111 << 7) | (n - 37), 16)


def _floorlog2(n: int) -> int:
    return n.bit_length() - 1


# --------------------------------------------------------------- writer

def _markers_siz(h, w, prec, signed, nc, tile):
    body = struct.pack(">HIIIIIIIIH", 0x4000, w, h, 0, 0, tile[1], tile[0],
                       0, 0, nc)
    for c in range(nc):
        body += bytes([(prec[c] - 1) | (0x80 if signed[c] else 0), 1, 1])
    return b"\xff\x51" + struct.pack(">H", 2 + len(body)) + body


def _segment(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, 2 + len(body)) + body


def encode(image: np.ndarray, *, levels: int = 5, irreversible: bool = False,
           cblk: tuple = (64, 64), precincts: Optional[Sequence] = None,
           tile: Optional[tuple] = None, layers: int = 1,
           layer_of: str = "all", progression: str = "LRCP",
           refine: Optional[str] = None, style: int = 0, mct: bool = True,
           guard_bits: int = 2, step_exponent: int = 1, sop: bool = False,
           eph: bool = False, cpf: bool = False, prec: int = 8,
           signed: bool = False, opj_segments: bool = False,
           edit=None) -> bytes:
    """A raw HTJ2K codestream of `image` ([h, w] or [h, w, c] integers of
    `prec` bits). `cblk` (width, height); `precincts` one (width, height)
    exponent pair a resolution, lowest first (None: no precincts); `tile`
    (height, width); `layers` quality layers with `layer_of` the policy:
    "all" every pass in layer 0, "spread" code-block k's passes first in
    layer k % layers, "refinement" each cleanup in layer 0 and the
    refinement passes in the last layer, "split" the SigProp and MagRef
    passes in layers of their own (1 and 2); `refine` as encode_block;
    `style` more code-block style bits beside HT; `step_exponent` the
    irreversible step size 2**-step_exponent; `cpf` adds a CPF marker;
    `opj_segments` signals a later packet's passes as OpenJPEG 2.5.4 reads
    them (its Part-1 segment limits: a first pass of no bytes still in the
    cleanup's segment, the rest in the refinement segment) instead of as
    the standard has them (every pass in the refinement segment); `edit`,
    a test's hook, is called with each coded code-block (its `segments`,
    `passes`, `plane`, `mb` and `layers`) before tier 2, to write what no
    encoder writes."""
    img = np.asarray(image).astype(np.int64)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    tile = tile or (h, w)
    numres = levels + 1
    cbw, cbh = (int(cblk[0]).bit_length() - 1, int(cblk[1]).bit_length() - 1)
    assert 1 << cbw == cblk[0] and 1 << cbh == cblk[1]
    if precincts is None:
        prec_exp = [(15, 15)] * numres
    else:
        prec_exp = [tuple(p) for p in precincts]
        assert len(prec_exp) == numres
    use_mct = mct and nc >= 3
    real = irreversible
    shift = 0 if signed else 1 << (prec - 1)
    # sub-band step sizes and magnitude bit-planes (Mb = expn + G - 1)
    nb = 3 * levels + 1
    gains = [0] + [g for _ in range(levels) for g in (1, 1, 2)]
    if real:
        expn = [prec + step_exponent] * nb
        steps = [2.0 ** -step_exponent] * nb
    else:
        expn = [prec + g for g in gains]
        steps = [1.0] * nb
    guard = guard_bits
    tiles_out = []
    th_n = _cdiv(h, tile[0])
    tw_n = _cdiv(w, tile[1])
    # first pass: code every tile's blocks, raising the guard bits until
    # every magnitude fits
    while True:
        try:
            coded = []
            for t in range(th_n * tw_n):
                coded.append(_code_tile(img, t, tw_n, tile, h, w, nc, numres,
                                        levels, real, use_mct, shift, expn,
                                        steps, guard, (cbw, cbh), prec_exp,
                                        refine, style))
            break
        except OverflowError:
            guard += 1
            assert guard <= 7
    for t, geo in enumerate(coded):
        _assign_layers(geo, layers, layer_of)
        if edit is not None:
            for b in _blocks(geo):
                edit(b)
        tiles_out.append(_tile_packets(geo, layers, progression, sop, eph,
                                       opj_segments))
    # the main header
    siz = _markers_siz(h, w, [prec] * nc, [signed] * nc, nc, tile)
    cap = _segment(0xFF50, struct.pack(">IH", 0x00020000, 0))
    scod = ((1 if precincts is not None else 0) | (2 if sop else 0)
            | (4 if eph else 0))
    cod_body = struct.pack(">BBHB", scod, PROGRESSIONS[progression], layers,
                           1 if use_mct else 0)
    cod_body += bytes([levels, cbw - 2, cbh - 2, HT | style, 0 if real else 1])
    if precincts is not None:
        cod_body += bytes((py << 4) | px for px, py in prec_exp)
    cod = _segment(0xFF52, cod_body)
    if real:
        qcd_body = bytes([(guard << 5) | 2]) + b"".join(
            struct.pack(">H", (e << 11) | int(round((s * 2 ** (e - prec) - 1)
                                                    * 2048)))
            for e, s in zip(expn, steps))
    else:
        qcd_body = bytes([guard << 5]) + bytes(e << 3 for e in expn)
    qcd = _segment(0xFF5C, qcd_body)
    head = b"\xff\x4f" + siz + cap
    if cpf:
        head += _segment(0xFF59, struct.pack(">H", 0x000F))
    head += cod + qcd
    body = b""
    for t, data in enumerate(tiles_out):
        psot = 12 + 2 + len(data)
        body += struct.pack(">HHHIBB", 0xFF90, 10, t, psot, 0, 1)
        body += b"\xff\x93" + data
    return head + body + b"\xff\xd9"


def _code_tile(img, t, tw_n, tile, h, w, nc, numres, levels, real, use_mct,
               shift, expn, steps, guard, cblk, prec_exp, refine, style):
    """The tile's geometry with every code-block coded."""
    ty, tx = divmod(t, tw_n)
    x0, y0 = tx * tile[1], ty * tile[0]
    x1, y1 = min(x0 + tile[1], w), min(y0 + tile[0], h)
    planes = [img[y0:y1, x0:x1, c] - shift for c in range(nc)]
    if use_mct:
        r, g, b = planes[:3]
        if real:
            r, g, b = (p.astype(np.float64) for p in (r, g, b))
            planes[:3] = [0.299 * r + 0.587 * g + 0.114 * b,
                          -0.16875 * r - 0.33126 * g + 0.5 * b,
                          0.5 * r - 0.41869 * g - 0.08131 * b]
        else:
            planes[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
    comps = []
    for c in range(nc):
        coef = forward_dwt(planes[c], levels, x0, y0, real)
        geo = _tile_geometry(x0, y0, x1, y1, numres, cblk, prec_exp)
        for r, (rect, pw, ph, bands) in enumerate(geo):
            for bandno, (bx0, by0, bx1, by1), precincts in bands:
                bi = 0 if r == 0 else 3 * (r - 1) + bandno
                mb = expn[bi] + guard - 1
                offx = offy = 0
                if bandno & 1:
                    offx = geo[r - 1][0][2] - geo[r - 1][0][0]
                if bandno & 2:
                    offy = geo[r - 1][0][3] - geo[r - 1][0][1]
                for pr in precincts:
                    for b in pr.blocks:
                        if b.x1 <= b.x0 or b.y1 <= b.y0:
                            continue
                        ys = slice(b.y0 - by0 + offy, b.y1 - by0 + offy)
                        xs = slice(b.x0 - bx0 + offx, b.x1 - bx0 + offx)
                        v = coef[ys, xs]
                        if real:
                            q = (np.sign(v) * np.floor(np.abs(v) / steps[bi])
                                 ).astype(np.int64)
                        else:
                            q = v.astype(np.int64)
                        if np.abs(q).max(initial=0) >= 1 << mb:
                            raise OverflowError
                        got = encode_block(q, refine, bool(style & VSC))
                        if got is None:
                            continue
                        b.segments, b.passes, b.plane = got
                        b.mb = mb
        comps.append(geo)
    return comps


def _assign_layers(comps, layers: int, policy: str) -> None:
    """Each code-block's passes over the layers: b.layers = [(layer, new
    passes, segment lengths, bytes)]."""
    for k, b in enumerate(_blocks(comps)):
        cl = b.segments[0]
        ref = b"".join(b.segments[1:])
        first = k % layers if policy == "spread" else 0
        if b.passes == 1:
            b.layers = [(first, 1, [len(cl)], cl)]
        elif policy in ("all", "spread"):
            b.layers = [(first, b.passes, [len(cl), len(ref)], cl + ref)]
        elif policy == "refinement":
            b.layers = [(0, 1, [len(cl)], cl),
                        (layers - 1, b.passes - 1, [len(ref)], ref)]
        elif policy == "split":
            # SigProp's bytes, then MagRef's: one refinement segment
            # across two packets
            assert layers >= 3 and b.passes == 3
            spp, mrp = b.segments[1:]
            b.layers = [(0, 1, [len(cl)], cl), (1, 1, [len(spp)], spp),
                        (2, 1, [len(mrp)], mrp)]
        else:
            raise ValueError(policy)


def _blocks(comps):
    """Every coded code-block of a tile."""
    for geo in comps:
        for rect, pw, ph, bands in geo:
            for _, _, precincts in bands:
                for pr in precincts:
                    for b in pr.blocks:
                        if b.segments is not None:
                            yield b


def _packet(geo_res, bands_prec, layer: int, sop_index: Optional[int],
            eph: bool, opj_segments: bool) -> bytes:
    """One packet: its header (tier 2 as OpenJPEG reads an HT code-block's
    segments: the cleanup's length in Lblock bits, the refinement
    segment's in Lblock + floor(log2 passes)) and its body."""
    bits = _Bits()
    entries = []
    for pr in bands_prec:
        for k, b in enumerate(pr.blocks):
            if b.segments is not None and b.layers:
                pr.incl.set(k, b.layers[0][0])
                pr.imsb.set(k, b.mb - 1 - b.plane)
    present = any(lay == layer for pr in bands_prec for b in pr.blocks
                  if b.segments is not None for lay, *_ in b.layers)
    bits.put(1 if present else 0)
    if present:
        for pr in bands_prec:
            for k, b in enumerate(pr.blocks):
                contrib = [c for c in b.layers if c[0] == layer] \
                    if b.segments is not None else []
                if not b.included:
                    pr.incl.encode(bits, k, layer + 1)
                else:
                    bits.put(1 if contrib else 0)
                if not contrib:
                    continue
                _, npasses, lens, data = contrib[0]
                if not b.included:
                    pr.imsb.encode(bits, k, 999)
                    first = True
                else:
                    first = False
                b.included = True
                _numpasses(bits, npasses)
                # the segments' pass counts: the cleanup alone, the rest in
                # one refinement segment
                if first:
                    counts = [1] + ([npasses - 1] if npasses > 1 else [])
                elif opj_segments and npasses > 1:
                    counts, lens = [1, npasses - 1], [0] + list(lens)
                else:
                    counts = [npasses]
                need = max(max(ln.bit_length() - _floorlog2(n), 0)
                           for ln, n in zip(lens, counts))
                inc = max(need - b.lblock, 0)
                bits.put((1 << (inc + 1)) - 2, inc + 1)
                b.lblock += inc
                for ln, n in zip(lens, counts):
                    bits.put(ln, b.lblock + _floorlog2(n))
                entries.append(data)
    header = bits.flush()
    out = b""
    if sop_index is not None:
        out += struct.pack(">HHH", 0xFF91, 4, sop_index & 0xFFFF)
    out += header
    if eph:
        out += b"\xff\x92"
    for data in entries:
        out += data
    return out


def _tile_packets(comps, layers: int, progression: str, sop: bool,
                  eph: bool, opj_segments: bool) -> bytes:
    """Every packet of a tile in `progression` order."""
    numres = len(comps[0])
    order = []
    nc = len(comps)
    if progression == "LRCP":
        for lay in range(layers):
            for r in range(numres):
                for c in range(nc):
                    order += [(lay, r, c, k) for k in range(
                        comps[c][r][1] * comps[c][r][2])]
    elif progression == "RLCP":
        for r in range(numres):
            for lay in range(layers):
                for c in range(nc):
                    order += [(lay, r, c, k) for k in range(
                        comps[c][r][1] * comps[c][r][2])]
    else:  # RPCL, every component of the same geometry
        for r in range(numres):
            for k in range(comps[0][r][1] * comps[0][r][2]):
                for c in range(nc):
                    order += [(lay, r, c, k) for lay in range(layers)]
    out = b""
    for n, (lay, r, c, k) in enumerate(order):
        bands = comps[c][r][3]
        prs = [precincts[k] for _, (bx0, by0, bx1, by1), precincts in bands
               if bx1 > bx0 and by1 > by0]
        out += _packet(comps[c][r], prs, lay, n if sop else None, eph,
                       opj_segments)
    return out


# ------------------------------------------------------------------ JPH

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jph_file(codestream: bytes, height: int, width: int, nc: int,
             bpc: int = 7, enumcs: Optional[int] = None) -> bytes:
    """A JPH file (ISO 15444-15 Annex D: the JP2 file format, brand `jph `)
    around a codestream: signature, ftyp, jp2h (ihdr, colr of `enumcs`,
    sRGB for 3 or 4 components and greyscale else by default) and jp2c."""
    if enumcs is None:
        enumcs = 16 if nc >= 3 else 17
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", height, width, nc, bpc, 7,
                                     0, 0))
    colr = _box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    return (_box(b"jP  ", b"\r\n\x87\n")
            + _box(b"ftyp", b"jph " + bytes(4) + b"jph ")
            + _box(b"jp2h", ihdr + colr) + _box(b"jp2c", codestream))
