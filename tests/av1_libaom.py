"""The AV1 tables of the port's AV1 decoder (maskrcnn_tpu_torch/csrc/
av1_tables.h), read off OpenCV's bundled libaom 3.14.1, whose ELF file
keeps its full symbol table, and written by `python tests/image_corpus.py
--av1-tables`. The values are the AV1 specification's; the decoding
process that uses them is written from the specification.

Tables the library names (`default_kf_y_mode_cdf`, `dc_qlookup_QTX`,
`dr_intra_derivative`, `av1_default_coeff_base_multi_cdfs`, the scans,
...) are read by symbol name and size from `.symtab` and `.rodata` by a
small ELF reader (no cv2 import). The compiler folded the smallest CDF
tables into the code of `av1_init_mode_probs`, which copies every default
CDF into a FRAME_CONTEXT: those are read from a FRAME_CONTEXT that
function fills (a ctypes call into the library, by its symbol's
address), located by the copies of the named tables in it and checked by
their structure (each CDF non-increasing to 0, then a zero counter).

libaom keeps each CDF as AOM_ICDF values (32768 - cdf) followed by one
counter slot; the header holds the specification's form: the cumulative
values, 32768 last, then the counter slot. libaom 3.x keeps coefficients
column by column: its scans and context-offset tables are turned into
the specification's row-major positions (row * width + column).
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
from pathlib import Path

import numpy as np

HEADER = (Path(__file__).resolve().parent.parent / "maskrcnn_tpu_torch"
          / "csrc" / "av1_tables.h")


def libaom_path():
    """OpenCV's bundled libaom 3.14.1, or None where it is absent."""
    import importlib.util
    spec = importlib.util.find_spec("cv2")
    roots = []
    if spec is not None and spec.origin:
        roots.append(os.path.dirname(os.path.dirname(spec.origin)))
    for root in roots:
        found = sorted(glob.glob(os.path.join(
            root, "opencv_python*.libs", "libaom-*.so.3.14.1")))
        if found:
            return Path(found[0])
    return None


class Elf:
    """A 64-bit little-endian ELF file's sections and `.symtab`."""

    def __init__(self, path):
        self.d = d = Path(path).read_bytes()
        if d[:4] != b"\x7fELF" or d[4] != 2 or d[5] != 1:
            raise ValueError(f"{path}: not a 64-bit little-endian ELF")
        shoff, = struct.unpack_from("<Q", d, 0x28)
        entsize, count, names = struct.unpack_from("<HHH", d, 0x3A)
        self.sections = []
        for i in range(count):
            (name, kind, _, addr, off, size, link, _, _,
             _) = struct.unpack_from("<IIQQQQIIQQ", d, shoff + i * entsize)
            self.sections.append({"name": name, "type": kind, "addr": addr,
                                  "off": off, "size": size, "link": link})
        base = self.sections[names]["off"]
        for s in self.sections:
            s["name"] = self._str(base + s["name"])
        self.symbols = {}
        for s in self.sections:
            if s["type"] != 2:                              # SHT_SYMTAB
                continue
            strtab = self.sections[s["link"]]["off"]
            for j in range(s["size"] // 24):
                name, _, _, _, value, size = struct.unpack_from(
                    "<IBBHQQ", d, s["off"] + j * 24)
                self.symbols.setdefault(self._str(strtab + name),
                                        (value, size))

    def _str(self, at: int) -> str:
        return self.d[at:self.d.index(b"\0", at)].decode()

    def offset(self, addr: int) -> int:
        for s in self.sections:
            if s["type"] == 1 and s["addr"] <= addr < s["addr"] + s["size"]:
                return addr - s["addr"] + s["off"]
        raise KeyError(hex(addr))

    def data(self, name: str) -> bytes:
        addr, size = self.symbols[name]
        at = self.offset(addr)
        return self.d[at:at + size]

    def pointers(self, name: str):
        """The symbols an array of pointers in .data points at, through
        its R_X86_64_RELATIVE relocations."""
        addr, size = self.symbols[name]
        starts = {v[0]: k for k, v in self.symbols.items() if v[1]}
        out = {}
        for s in self.sections:
            if s["type"] != 4:                              # SHT_RELA
                continue
            for j in range(s["size"] // 24):
                off, info, addend = struct.unpack_from("<QQq", self.d,
                                                       s["off"] + j * 24)
                if addr <= off < addr + size and info & 0xFFFFFFFF == 8:
                    out[off] = starts[addend]
        return [out[addr + 8 * i] for i in range(size // 8)]

    def values(self, name: str, fmt: str):
        raw = self.data(name)
        n = len(raw) // struct.calcsize(fmt)
        return list(struct.unpack(f"<{n}{fmt}", raw))


def _frame_context(elf: Elf, path) -> bytes:
    """The FRAME_CONTEXT `av1_init_mode_probs` fills (a zeroed buffer
    larger than the struct; the function only copies the defaults)."""
    lib = ctypes.CDLL(str(path))
    anchor = ctypes.cast(lib.aom_codec_av1_dx, ctypes.c_void_p).value
    base = anchor - elf.symbols["aom_codec_av1_dx"][0]
    init = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(
        base + elf.symbols["av1_init_mode_probs"][0])
    buf = ctypes.create_string_buffer(1 << 16)
    init(ctypes.addressof(buf))
    return buf.raw


def _cdfs(words, n: int, stride: int = None):
    """ICDF rows of `n` symbols (stride words apart, default n + 1) as
    the specification's rows of n + 1 words; checked."""
    stride = stride or n + 1
    out = []
    for at in range(0, len(words), stride):
        row = words[at:at + stride]
        icdf = row[:n]
        if icdf[-1] != 0 or row[n] != 0 or any(
                a < b for a, b in zip(icdf, icdf[1:])):
            raise ValueError(f"not a CDF of {n} symbols: {row}")
        out.append([32768 - v for v in icdf] + [0])
    return out


def read_tables(path=None) -> dict:
    """Every table av1_tables.h holds, by its C name: (C type, dims,
    flat values)."""
    path = path or libaom_path()
    if path is None:
        raise FileNotFoundError("OpenCV's libaom 3.14.1 is not installed")
    elf = Elf(path)
    u16 = lambda name: elf.values(name, "H")                    # noqa: E731
    t = {}

    def cdf(cname, words, dims, n, stride=None):
        rows = _cdfs(words, n, stride)
        flat = [v for r in rows for v in r]
        t[cname] = ("uint16_t", dims + [n + 1], flat)

    # named CDF tables
    cdf("kKfYModeCdf", u16("default_kf_y_mode_cdf"), [5, 5], 13)
    uv = u16("default_uv_mode_cdf")
    rows = _cdfs(uv[:13 * 15], 13, 15) + _cdfs(uv[13 * 15:], 14, 15)
    t["kUvModeCdf"] = ("uint16_t", [2, 13, 15],
                       [v for r in rows for v in r + [0] * (15 - len(r))])
    part = u16("default_partition_cdf")
    rows = []
    for ctx in range(20):
        n = 4 if ctx < 4 else 8 if ctx >= 16 else 10
        r = _cdfs(part[ctx * 11:ctx * 11 + 11], n, 11)[0]
        rows.append(r + [0] * (11 - len(r)))
    t["kPartitionCdf"] = ("uint16_t", [20, 11], [v for r in rows for v in r])
    ext = u16("default_intra_ext_tx_cdf")
    rows = []
    for s in range(3):
        for i in range(4 * 13):
            at = (s * 52 + i) * 17
            if s == 0:
                rows.append([0] * 17)
                continue
            n = 7 if s == 1 else 5
            r = _cdfs(ext[at:at + 17], n, 17)[0]
            rows.append(r + [0] * (17 - len(r)))
    t["kIntraTxTypeCdf"] = ("uint16_t", [3, 4, 13, 17],
                            [v for r in rows for v in r])
    # palette colours: rows of 2 + size index symbols
    for name, sym in (("kPaletteYColorCdf",
                       "default_palette_y_color_index_cdf"),
                      ("kPaletteUvColorCdf",
                       "default_palette_uv_color_index_cdf")):
        words = u16(sym)
        rows = []
        for size in range(7):
            for ctx in range(5):
                at = (size * 5 + ctx) * 9
                r = _cdfs(words[at:at + 9], size + 2, 9)[0]
                rows.append(r + [0] * (9 - len(r)))
        t[name] = ("uint16_t", [7, 5, 9], [v for r in rows for v in r])
    cdf("kTxbSkipCdf", u16("av1_default_txb_skip_cdfs"), [4, 5, 13], 2)
    cdf("kEobExtraCdf", u16("av1_default_eob_extra_cdfs"), [4, 5, 2, 9], 2)
    cdf("kDcSignCdf", u16("av1_default_dc_sign_cdfs"), [4, 2, 3], 2)
    for size, n in ((16, 5), (32, 6), (64, 7), (128, 8), (256, 9),
                    (512, 10), (1024, 11)):
        cdf(f"kEobPt{size}Cdf", u16(f"av1_default_eob_multi{size}_cdfs"),
            [4, 2, 2], n)
    cdf("kCoeffBaseEobCdf", u16("av1_default_coeff_base_eob_multi_cdfs"),
        [4, 5, 2, 4], 3)
    cdf("kCoeffBaseCdf", u16("av1_default_coeff_base_multi_cdfs"),
        [4, 5, 2, 42], 4)
    cdf("kCoeffBrCdf", u16("av1_default_coeff_lps_multi_cdfs"),
        [4, 5, 2, 21], 4)

    # the small CDFs, from the FRAME_CONTEXT av1_init_mode_probs fills
    fc = _frame_context(elf, path)

    def at(sym):
        raw = elf.data(sym)
        i = fc.find(raw)
        if i < 0 or fc.find(raw, i + 1) >= 0:
            raise ValueError(f"{sym}: not found once in the FRAME_CONTEXT")
        return i

    def words(off, count):
        return list(struct.unpack_from(f"<{count}H", fc, off))

    kf, uvm = at("default_kf_y_mode_cdf"), at("default_uv_mode_cdf")
    intra_ext, inter_ext = (at("default_intra_ext_tx_cdf"),
                            at("default_inter_ext_tx_cdf"))
    pal_y, pal_uv = (at("default_palette_y_color_index_cdf"),
                     at("default_palette_uv_color_index_cdf"))
    # after kf_y_cdf: angle_delta [8][8], tx_size [4][3][4], delta_q [5],
    # delta_lf_multi [4][5], delta_lf [5], then intra_ext_tx_cdf
    angle = kf + 25 * 14 * 2
    tx = angle + 8 * 8 * 2
    dq = tx + 12 * 4 * 2
    dlf_multi = dq + 5 * 2
    dlf = dlf_multi + 4 * 5 * 2
    if dlf + 5 * 2 != intra_ext:
        raise ValueError("FRAME_CONTEXT layout: delta_lf is not before "
                         "intra_ext_tx_cdf")
    cdf("kAngleDeltaCdf", words(angle, 64), [8], 7)
    txw = words(tx, 48)
    rows = []
    for cat in range(4):
        for ctx in range(3):
            n = 2 if cat == 0 else 3
            r = _cdfs(txw[(cat * 3 + ctx) * 4:(cat * 3 + ctx) * 4 + 4],
                      n, 4)[0]
            rows.append(r + [0] * (4 - len(r)))
    t["kTxSizeCdf"] = ("uint16_t", [4, 3, 4], [v for r in rows for v in r])
    cdf("kDeltaQCdf", words(dq, 5), [], 4)
    cdf("kDeltaLfMultiCdf", words(dlf_multi, 20), [4], 4)
    cdf("kDeltaLfCdf", words(dlf, 5), [], 4)
    # after inter_ext_tx_cdf [4][4][17]: cfl_sign [9], cfl_alpha [6][17]
    cfl_sign = inter_ext + len(elf.data("default_inter_ext_tx_cdf"))
    cdf("kCflSignCdf", words(cfl_sign, 9), [], 8)
    cdf("kCflAlphaCdf", words(cfl_sign + 18, 6 * 17), [6], 16)
    # before uv_mode_cdf: ... skip_txfm [3][3], intra_inter [4][3], nmvc,
    # ndvc (not filled here), intrabc [3], seg (pred [3][3], spatial
    # [3][9]), filter_intra [22][3], filter_intra_mode [6],
    # switchable_restore [4], wiener_restore [3], sgrproj_restore [3],
    # y_mode [4][14]
    nmv = len(elf.data("default_nmv_context"))
    y_mode = uvm - 4 * 14 * 2
    sgrproj = y_mode - 3 * 2
    wiener = sgrproj - 3 * 2
    restore = wiener - 4 * 2
    fi_mode = restore - 6 * 2
    fi = fi_mode - 22 * 3 * 2
    seg = fi - 27 * 2
    intrabc = seg - 9 * 2 - 3 * 2
    skip = intrabc - 2 * nmv - 12 * 2 - 9 * 2
    cdf("kSkipCdf", words(skip, 9), [3], 2)
    cdf("kIntrabcCdf", words(intrabc, 3), [], 2)
    cdf("kSegmentIdCdf", words(seg, 27), [3], 8)
    cdf("kFilterIntraCdf", words(fi, 66), [22], 2)
    cdf("kFilterIntraModeCdf", words(fi_mode, 6), [], 5)
    cdf("kRestoreSwitchableCdf", words(restore, 4), [], 3)
    cdf("kRestoreWienerCdf", words(wiener, 3), [], 2)
    cdf("kRestoreSgrprojCdf", words(sgrproj, 3), [], 2)
    # around the palette colour tables: y_size [7][8], uv_size [7][8]
    # before; y_mode [7][3][3], uv_mode [2][3] after the uv colours
    cdf("kPaletteYSizeCdf", words(pal_y - 2 * 56 * 2, 56), [7], 7)
    cdf("kPaletteUvSizeCdf", words(pal_y - 56 * 2, 56), [7], 7)
    pal_y_mode = pal_uv + 7 * 5 * 9 * 2
    cdf("kPaletteYModeCdf", words(pal_y_mode, 63), [7, 3], 2)
    cdf("kPaletteUvModeCdf", words(pal_y_mode + 63 * 2, 6), [2], 2)

    # quantizers, intra prediction, filters
    # iwt_matrix_ref [15 levels][luma, chroma][3344]: the matrices of the
    # coded sizes one after the other, each column-major in libaom 3.x
    qm = elf.values("iwt_matrix_ref", "B")
    qm_sizes = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
                (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)]
    rows = []
    for level in range(15 * 2):
        block = qm[level * 3344:(level + 1) * 3344]
        at = 0
        for w, h in qm_sizes:
            col_major = block[at:at + w * h]
            rows += [col_major[c * h + r] for r in range(h) for c in range(w)]
            at += w * h
    t["kQuantizerMatrix"] = ("uint8_t", [15, 2, 3344], rows)
    t["kDcQLookup"] = ("int16_t", [256], elf.values("dc_qlookup_QTX", "h"))
    t["kAcQLookup"] = ("int16_t", [256], elf.values("ac_qlookup_QTX", "h"))
    t["kDrIntraDerivative"] = ("int16_t", [90],
                               elf.values("dr_intra_derivative", "h"))
    t["kModeToAngle"] = ("uint8_t", [13], elf.values("mode_to_angle_map",
                                                     "B"))
    t["kSmoothWeights"] = ("uint8_t", [124], elf.values("smooth_weights",
                                                        "B"))
    t["kFilterIntraTaps"] = ("int8_t", [5, 8, 8],
                             elf.values("av1_filter_intra_taps", "b"))
    t["kSgrParams"] = ("int32_t", [16, 4], elf.values("av1_sgr_params", "i"))
    t["kXByXPlus1"] = ("int32_t", [256], elf.values("av1_x_by_xplus1", "i"))
    t["kOneByX"] = ("int32_t", [25], elf.values("av1_one_by_x", "i"))
    cospi = elf.values("av1_cospi_arr_data", "i")
    t["kCosPi"] = ("int32_t", [64], cospi[2 * 64:3 * 64])      # cos_bit 12
    sinpi = elf.values("av1_sinpi_arr_data", "i")
    t["kSinPi"] = ("int32_t", [5], sinpi[2 * 5:3 * 5])
    t["kPaletteColorContext"] = (
        "int32_t", [9], elf.values("av1_palette_color_index_context_lookup",
                                   "i"))
    # cdef_directions_padded: [dir + 2][2] offsets over a stride of 144
    pad = elf.values("cdef_directions_padded", "i")
    dirs = []
    for d in range(8):
        for k in range(2):
            v = pad[(d + 2) * 2 + k]
            r = (v + 72) // 144
            dirs += [r, v - r * 144]
    t["kCdefDirections"] = ("int8_t", [8, 2, 2], dirs)

    # scans and coefficient context offsets, row-major
    sizes = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
             (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)]
    for kind in ("default", "mrow", "mcol"):
        for w, h in sizes:
            col_major = elf.values(f"{kind}_scan_{w}x{h}", "h")
            t[f"k{kind.capitalize()}Scan{w}x{h}"] = (
                "int16_t", [w * h], [(p % h) * w + p // h for p in col_major])
    # av1_nz_map_ctx_offset[TX_SIZES_ALL]: a table a transform size (the
    # pointers of .data through their relocations), read at the coded
    # (at most 32x32) width and height; the specification keeps each
    # size's offsets for rows and columns 0-4 (Min(row, 4), Min(col, 4))
    tx = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
          (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32), (4, 16),
          (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]
    offsets = []
    for i, table in enumerate(elf.pointers("av1_nz_map_ctx_offset")):
        w, h = min(tx[i][0], 32), min(tx[i][1], 32)
        col_major = elf.values(table, "b")
        grid = [[col_major[c * h + r] for c in range(w)] for r in range(h)]
        for r in range(h):
            for c in range(w):
                if grid[r][c] != grid[min(r, 4)][min(c, 4)]:
                    raise ValueError(f"{table}: not constant past 4")
        offsets += [grid[min(r, h - 1)][min(c, w - 1)] for r in range(5)
                    for c in range(5)]
    t["kCoeffBaseCtxOffset"] = ("int8_t", [19, 5, 5], offsets)
    return t


def header(tables: dict) -> str:
    def body(values, per=16):
        items = [str(v) for v in values]
        return ",\n".join("    " + ", ".join(items[i:i + per])
                          for i in range(0, len(items), per))

    out = [
        "// The AV1 specification's default CDFs and tables as OpenCV's",
        "// bundled libaom 3.14.1 holds them: generated by `python",
        "// tests/image_corpus.py --av1-tables` (tests/av1_libaom.py);",
        "// do not edit. CDFs in the specification's form: cumulative",
        "// values, 32768 last, then the adaptation counter. Scans and",
        "// coefficient context offsets by row-major position.",
        "#pragma once", "", "#include <cstdint>", "", "namespace mrt {",
        "namespace av1 {", ""]
    for name in sorted(tables):
        ctype, dims, values = tables[name]
        n = 1
        for d in dims:
            n *= d
        if n != len(values):
            raise ValueError(f"{name}: {len(values)} values for {dims}")
        shape = "".join(f"[{d}]" for d in dims)
        out += [f"inline constexpr {ctype} {name}{shape} = {{",
                body(values) + "};", ""]
    out += ["}  // namespace av1", "}  // namespace mrt", ""]
    return "\n".join(out)


# ------------------------------------------------------------ the encoder

def encode_av1(planes, depth: int = 8, profile: int = 0, mono: bool = False,
               superres_denominator: int = 0) -> bytes:
    """One AV1 key frame of `planes` (Y[, U, V] 4:2:0, uint8 or uint16) by
    OpenCV's libaom encoder (good-quality usage, one frame, no lag) as
    AVIF item data: the sequence header and frame OBUs (the temporal
    delimiter dropped). `depth` 10 or 12 encode high-bit-depth data
    (profile 2 for 12); `superres_denominator` 9-16 codes the frame
    superres-scaled (AOM_SUPERRES_FIXED). The aom_codec_enc_cfg_t and
    aom_image_t fields are set at their offsets in libaom 3.14's structs,
    checked against aom_codec_enc_config_default's and aom_img_alloc's
    values first."""
    path = libaom_path()
    if path is None:
        raise FileNotFoundError("OpenCV's libaom 3.14.1 is not installed")
    lib = ctypes.CDLL(str(path))
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.aom_codec_av1_cx.restype = vp
    lib.aom_codec_enc_config_default.argtypes = [vp, vp, ctypes.c_uint]
    lib.aom_codec_enc_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    lib.aom_img_alloc.restype = vp
    lib.aom_img_alloc.argtypes = [vp, ctypes.c_int, ctypes.c_uint,
                                  ctypes.c_uint, ctypes.c_uint]
    lib.aom_img_free.argtypes = [vp]
    lib.aom_codec_encode.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_ulong,
                                     ctypes.c_long]
    lib.aom_codec_get_cx_data.restype = vp
    lib.aom_codec_get_cx_data.argtypes = [vp, vp]
    lib.aom_codec_destroy.argtypes = [vp]
    h, w = planes[0].shape
    iface = lib.aom_codec_av1_cx()
    cfg = ctypes.create_string_buffer(4096)
    if lib.aom_codec_enc_config_default(iface, cfg, 0):
        raise RuntimeError("aom_codec_enc_config_default failed")
    field = lambda off: u32.from_buffer(cfg, off)                # noqa: E731
    if [field(o).value for o in (12, 16, 32, 40, 44, 56, 80)] != [
            320, 240, 8, 1, 30, 35, 8]:
        raise RuntimeError("libaom's aom_codec_enc_cfg_t layout")
    for off, v in ((8, profile), (12, w), (16, h), (20, 1), (32, depth),
                   (36, depth), (56, 0)):
        field(off).value = v
    if superres_denominator:
        field(76).value = 1                                 # FIXED
        field(80).value = superres_denominator
        field(84).value = superres_denominator
    ctx = ctypes.create_string_buffer(512)
    flags = 0x40000 if depth > 8 else 0            # AOM_CODEC_USE_HIGHBITDEPTH
    # the encoder's ABI version: the one aom_codec_enc_init_ver takes
    # (AOM_CODEC_ABI_MISMATCH, 3, for any other)
    for version in range(64):
        err = lib.aom_codec_enc_init_ver(ctx, iface, cfg, flags, version)
        if err != 3:
            break
    if err:
        raise RuntimeError(f"aom_codec_enc_init_ver failed: {err}")
    fmt = 0x102 | (0x800 if depth > 8 else 0)
    img = lib.aom_img_alloc(None, fmt, w, h, 16)
    try:
        if [u32.from_address(img + o).value for o in (28, 32, 40, 44)] != [
                w, h, w, h]:
            raise RuntimeError("libaom's aom_image_t layout")
        u32.from_address(img + 36).value = depth
        u32.from_address(img + 16).value = int(mono)
        dtype = np.uint16 if depth > 8 else np.uint8
        for p, plane in enumerate(planes):
            ptr = ctypes.c_void_p.from_address(img + 64 + 8 * p).value
            stride = ctypes.c_int.from_address(img + 88 + 4 * p).value
            ph, pw = plane.shape
            rows = np.ctypeslib.as_array(
                (ctypes.c_uint8 * (stride * ph)).from_address(ptr)).reshape(
                    ph, stride)
            rows[:, :pw * dtype().itemsize] = np.ascontiguousarray(
                plane, dtype).view(np.uint8).reshape(ph, -1)
        out = b""
        for frame in (img, None):
            if lib.aom_codec_encode(ctx, frame, 0, 1, 0):
                raise RuntimeError("aom_codec_encode failed")
            it = ctypes.c_void_p(0)
            while True:
                pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
                if not pkt:
                    break
                if ctypes.c_int.from_address(pkt).value == 0:  # a frame
                    buf = ctypes.c_void_p.from_address(pkt + 8).value
                    size = ctypes.c_size_t.from_address(pkt + 16).value
                    out += ctypes.string_at(buf, size)
    finally:
        lib.aom_img_free(img)
        lib.aom_codec_destroy(ctx)
    # drop temporal delimiters (OBU type 2)
    obus, pos = b"", 0
    while pos < len(out):
        head = out[pos]
        ext = (head >> 2) & 1
        at = pos + 1 + ext
        size = shift = 0
        while True:
            byte = out[at]
            at += 1
            size |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        if (head >> 3) & 15 != 2:
            obus += out[pos:at + size]
        pos = at + size
    return obus


def decode_av1(obus: bytes):
    """The first frame of AV1 OBUs by OpenCV's libaom decoder: its 8-bit
    planes (Y, U, V; U and V None for 4:0:0), or a RuntimeError naming
    libaom's error."""
    path = libaom_path()
    if path is None:
        raise FileNotFoundError("OpenCV's libaom 3.14.1 is not installed")
    lib = ctypes.CDLL(str(path))
    vp = ctypes.c_void_p
    lib.aom_codec_av1_dx.restype = vp
    lib.aom_codec_dec_init_ver.argtypes = [vp, vp, vp, ctypes.c_long,
                                           ctypes.c_int]
    lib.aom_codec_decode.argtypes = [vp, ctypes.c_char_p, ctypes.c_size_t,
                                     vp]
    lib.aom_codec_get_frame.restype = vp
    lib.aom_codec_get_frame.argtypes = [vp, vp]
    lib.aom_codec_destroy.argtypes = [vp]
    ctx = ctypes.create_string_buffer(512)
    iface = lib.aom_codec_av1_dx()
    for version in range(64):
        err = lib.aom_codec_dec_init_ver(ctx, iface, None, 0, version)
        if err != 3:
            break
    if err:
        raise RuntimeError(f"aom_codec_dec_init_ver failed: {err}")
    try:
        if lib.aom_codec_decode(ctx, obus, len(obus), None):
            raise RuntimeError("libaom: aom_codec_decode failed")
        it = ctypes.c_void_p(0)
        img = lib.aom_codec_get_frame(ctx, ctypes.byref(it))
        if not img:
            raise RuntimeError("libaom: no frame")
        u32 = ctypes.c_uint32
        mono = u32.from_address(img + 16).value
        w, h = u32.from_address(img + 40).value, u32.from_address(img + 44).value
        xs, ys = u32.from_address(img + 56).value, u32.from_address(img + 60).value
        high = u32.from_address(img).value & 0x800
        out = []
        for p in range(1 if mono else 3):
            ptr = ctypes.c_void_p.from_address(img + 64 + 8 * p).value
            stride = ctypes.c_int.from_address(img + 88 + 4 * p).value
            pw = w if p == 0 else (w + xs) >> xs
            ph = h if p == 0 else (h + ys) >> ys
            rows = np.ctypeslib.as_array(
                (ctypes.c_uint8 * (stride * ph)).from_address(ptr)).reshape(
                    ph, stride)
            if high:
                rows = rows.view(np.uint16)
            out.append(rows[:, :pw].astype(np.uint8).copy())
        return out + [None] * (3 - len(out))
    finally:
        lib.aom_codec_destroy(ctx)
