"""A test-only JPEG 2000 writer: OpenJPEG 2.5's encoder in Pillow's bundled
libopenjp2 (`pillow.libs/libopenjp2-*.so`), driven by ctypes with every
option of `opj_cparameters_t` that Pillow's own writer does not reach
(code-block mode switches, SOP and EPH markers, POC, tile-parts, RGN
max-shift, components of their own precision, sign and subsampling),
and byte-level edits that no encoder writes: packet headers moved into
PPT or PPM markers, and JP2 boxes (CMYK, sYCC or another colr space, pclr
palettes, cdef) around a codestream.

`opj_cparameters_t` is mirrored as a ctypes.Structure; `check_layout`
holds it to the library (the defaults opj_set_default_encoder_parameters
writes land on their fields, nothing past the structure is written) and
`encode` reads back the markers its options write (COD's style byte, RGN,
POC), so that a layout that drifted fails loudly instead of writing other
files. Needs Pillow (for its libopenjp2); the tests skip without it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_MAXRLVLS = 33
_PATH_LEN = 4096
_TILESPECS = 16
_PACKSPECS = 16

PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
# code-block style bits (opj_cparameters_t.mode; COD's SPcod style byte)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
# opj_image_t.color_space
SRGB, GRAY, SYCC, EYCC, CMYK_SPACE = 1, 2, 3, 4, 5


class Poc(ctypes.Structure):
    _fields_ = [("resno0", ctypes.c_uint32), ("compno0", ctypes.c_uint32),
                ("layno1", ctypes.c_uint32), ("resno1", ctypes.c_uint32),
                ("compno1", ctypes.c_uint32), ("layno0", ctypes.c_uint32),
                ("precno0", ctypes.c_uint32), ("precno1", ctypes.c_uint32),
                ("prg1", ctypes.c_int), ("prg", ctypes.c_int),
                ("progorder", ctypes.c_char * 5), ("tile", ctypes.c_uint32),
                ("tx0", ctypes.c_int32), ("tx1", ctypes.c_int32),
                ("ty0", ctypes.c_int32), ("ty1", ctypes.c_int32)] + [
        (n, ctypes.c_uint32) for n in (
            "layS", "resS", "compS", "prcS", "layE", "resE", "compE", "prcE",
            "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t", "res_t",
            "comp_t", "prc_t", "tx0_t", "ty0_t")]


class CParameters(ctypes.Structure):
    """OpenJPEG 2.5's opj_cparameters_t."""
    _fields_ = [
        ("tile_size_on", ctypes.c_int), ("cp_tx0", ctypes.c_int),
        ("cp_ty0", ctypes.c_int), ("cp_tdx", ctypes.c_int),
        ("cp_tdy", ctypes.c_int), ("cp_disto_alloc", ctypes.c_int),
        ("cp_fixed_alloc", ctypes.c_int), ("cp_fixed_quality", ctypes.c_int),
        ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p),
        ("csty", ctypes.c_int), ("prog_order", ctypes.c_int),
        ("POC", Poc * 32), ("numpocs", ctypes.c_uint32),
        ("tcp_numlayers", ctypes.c_int), ("tcp_rates", ctypes.c_float * 100),
        ("tcp_distoratio", ctypes.c_float * 100),
        ("numresolution", ctypes.c_int), ("cblockw_init", ctypes.c_int),
        ("cblockh_init", ctypes.c_int), ("mode", ctypes.c_int),
        ("irreversible", ctypes.c_int), ("roi_compno", ctypes.c_int),
        ("roi_shift", ctypes.c_int), ("res_spec", ctypes.c_int),
        ("prcw_init", ctypes.c_int * _MAXRLVLS),
        ("prch_init", ctypes.c_int * _MAXRLVLS),
        ("infile", ctypes.c_char * _PATH_LEN),
        ("outfile", ctypes.c_char * _PATH_LEN), ("index_on", ctypes.c_int),
        ("index", ctypes.c_char * _PATH_LEN),
        ("image_offset_x0", ctypes.c_int), ("image_offset_y0", ctypes.c_int),
        ("subsampling_dx", ctypes.c_int), ("subsampling_dy", ctypes.c_int),
        ("decod_format", ctypes.c_int), ("cod_format", ctypes.c_int),
        ("jpwl_epc_on", ctypes.c_int), ("jpwl_hprot_MH", ctypes.c_int),
        ("jpwl_hprot_TPH_tileno", ctypes.c_int * _TILESPECS),
        ("jpwl_hprot_TPH", ctypes.c_int * _TILESPECS),
        ("jpwl_pprot_tileno", ctypes.c_int * _PACKSPECS),
        ("jpwl_pprot_packno", ctypes.c_int * _PACKSPECS),
        ("jpwl_pprot", ctypes.c_int * _PACKSPECS),
        ("jpwl_sens_size", ctypes.c_int), ("jpwl_sens_addr", ctypes.c_int),
        ("jpwl_sens_range", ctypes.c_int), ("jpwl_sens_MH", ctypes.c_int),
        ("jpwl_sens_TPH_tileno", ctypes.c_int * _TILESPECS),
        ("jpwl_sens_TPH", ctypes.c_int * _TILESPECS),
        ("cp_cinema", ctypes.c_int), ("max_comp_size", ctypes.c_int),
        ("cp_rsiz", ctypes.c_int), ("tp_on", ctypes.c_char),
        ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char),
        ("jpip_on", ctypes.c_int), ("mct_data", ctypes.c_void_p),
        ("max_cs_size", ctypes.c_int), ("rsiz", ctypes.c_uint16)]


class ImageCompParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class ImageComp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
        "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class Image(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int),
                ("comps", ctypes.POINTER(ImageComp)),
                ("icc_profile_buf", ctypes.c_void_p),
                ("icc_profile_len", ctypes.c_uint32)]


_LIB: Optional[ctypes.CDLL] = None
_MSG = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)
_messages: list = []


@_MSG
def _on_message(msg, _):
    _messages.append(msg.decode(errors="replace").strip())


def library() -> ctypes.CDLL:
    """Pillow's bundled libopenjp2 (OpenJPEG 2.5.4), its calls declared."""
    global _LIB
    if _LIB is None:
        import PIL
        libs = sorted(glob.glob(str(Path(PIL.__file__).parent.parent
                                    / "pillow.libs" / "libopenjp2-*.so*")))
        if not libs:
            raise OSError("Pillow's bundled libopenjp2 was not found")
        lib = ctypes.CDLL(libs[0])
        lib.opj_version.restype = ctypes.c_char_p
        lib.opj_image_create.restype = ctypes.POINTER(Image)
        lib.opj_image_create.argtypes = [ctypes.c_uint32,
                                         ctypes.POINTER(ImageCompParm),
                                         ctypes.c_int]
        lib.opj_create_compress.restype = ctypes.c_void_p
        lib.opj_create_compress.argtypes = [ctypes.c_int]
        lib.opj_setup_encoder.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(CParameters),
                                          ctypes.POINTER(Image)]
        lib.opj_encoder_set_extra_options.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)]
        lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
        lib.opj_stream_create_default_file_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_int]
        for name in ("opj_start_compress",):
            getattr(lib, name).argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(Image),
                                           ctypes.c_void_p]
        for name in ("opj_encode", "opj_end_compress"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for name in ("opj_set_error_handler", "opj_set_warning_handler"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, _MSG,
                                           ctypes.c_void_p]
        lib.opj_stream_destroy.argtypes = [ctypes.c_void_p]
        lib.opj_destroy_codec.argtypes = [ctypes.c_void_p]
        lib.opj_image_destroy.argtypes = [ctypes.POINTER(Image)]
        lib.opj_set_default_encoder_parameters.argtypes = [ctypes.c_void_p]
        lib.opj_set_MCT.argtypes = [ctypes.POINTER(CParameters),
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_uint32]
        lib.opj_set_MCT.restype = ctypes.c_int
        _LIB = lib
        check_layout()
    return _LIB


def check_layout() -> None:
    """The defaults opj_set_default_encoder_parameters writes land on the
    mirrored fields, and it writes nothing past the structure (its memset
    covers sizeof(opj_cparameters_t))."""
    lib = _LIB
    size = ctypes.sizeof(CParameters)
    raw = (ctypes.c_uint8 * (size + 256))(*([0xA5] * (size + 256)))
    lib.opj_set_default_encoder_parameters(raw)
    p = CParameters.from_buffer(raw)
    want = {"numresolution": 6, "cblockw_init": 64, "cblockh_init": 64,
            "prog_order": 0, "roi_compno": -1, "subsampling_dx": 1,
            "subsampling_dy": 1, "decod_format": -1, "cod_format": -1,
            "tcp_numlayers": 0, "numpocs": 0}
    got = {k: getattr(p, k) for k in want}
    assert got == want, got
    assert bytes(raw[size:]) == b"\xa5" * 256, "opj_cparameters_t is larger"
    assert 0xA5 not in bytes(raw[:size]), "opj_cparameters_t is smaller"


def version() -> str:
    return library().opj_version().decode()


def encode(planes: Sequence[np.ndarray], prec: Sequence[int] = None,
           signed: Sequence[bool] = None, sub: Sequence[tuple] = None,
           offset=(0, 0), color_space: int = 0, jp2: bool = False,
           resolutions: int = 6, cblk=(64, 64), mode: int = 0,
           irreversible: bool = False, mct: bool = False,
           progression: str = "LRCP", layers: Sequence[float] = (0,),
           tile=None, tile_offset=(0, 0), precincts=None, sop=False,
           eph=False, pocs=(), tile_parts: Optional[str] = None,
           roi=None, plt=False, tlm=False, custom_mct=None) -> bytes:
    """Encode components (each an int array [h_c, w_c] of its own size, the
    image's size in reference-grid units being planes[0]'s times its
    subsampling) as a raw J2K codestream, or JP2 where `jp2`;
    `resolutions` is capped at the levels OpenJPEG's encoder takes (1 +
    log2 of the smallest component's or tile's side).
    `pocs`: (resno0, compno0, layno1, resno1, compno1, "RPCL"), ...;
    `roi`: (component, shift); `tile_parts`: "R", "L" or "C";
    `custom_mct`: (matrix, dc_shift), an n x n float encoding matrix and
    n integer DC shifts for opj_set_MCT (Part-2 array-based MCT, MCC and
    MCO markers; COD's transform byte 2)."""
    lib = library()
    n = len(planes)
    side = min(min(p.shape) for p in planes)
    if tile:
        side = min(side, *tile)
    resolutions = max(1, min(resolutions, int(side).bit_length()))
    prec = prec or [8] * n
    signed = signed or [False] * n
    sub = sub or [(1, 1)] * n
    h0, w0 = planes[0].shape
    dx0, dy0 = sub[0]
    x0, y0 = offset
    x1, y1 = x0 + w0 * dx0, y0 + h0 * dy0
    parms = (ImageCompParm * n)()
    for i, plane in enumerate(planes):
        dx, dy = sub[i]
        cx0, cy0 = -(-x0 // dx), -(-y0 // dy)
        cw, ch = -(-x1 // dx) - cx0, -(-y1 // dy) - cy0
        assert plane.shape == (ch, cw), (plane.shape, ch, cw)
        parms[i] = ImageCompParm(dx, dy, cw, ch, cx0, cy0, prec[i], prec[i],
                                 int(signed[i]))
    image = lib.opj_image_create(n, parms, color_space)
    try:
        im = image.contents
        im.x0, im.y0, im.x1, im.y1 = x0, y0, x1, y1
        for i, plane in enumerate(planes):
            flat = np.ascontiguousarray(plane, np.int32).ravel()
            ctypes.memmove(im.comps[i].data, flat.ctypes.data, flat.nbytes)
        p = CParameters()
        lib.opj_set_default_encoder_parameters(ctypes.byref(p))
        p.numresolution = resolutions
        p.cblockw_init, p.cblockh_init = cblk
        p.mode = mode
        p.irreversible = int(irreversible)
        p.tcp_mct = bytes([int(mct)])
        p.prog_order = PROGRESSIONS[progression]
        p.tcp_numlayers = len(layers)
        for i, r in enumerate(layers):
            p.tcp_rates[i] = r
        p.cp_disto_alloc = 1
        if tile:
            p.tile_size_on = 1
            p.cp_tdx, p.cp_tdy = tile
            p.cp_tx0, p.cp_ty0 = tile_offset
        p.image_offset_x0, p.image_offset_y0 = x0, y0
        p.csty = (2 if sop else 0) | (4 if eph else 0)
        if precincts:
            p.csty |= 1
            p.res_spec = len(precincts)
            for i, (pw, ph) in enumerate(precincts):
                p.prcw_init[i], p.prch_init[i] = pw, ph
        for i, (r0, c0, l1, r1, c1, order) in enumerate(pocs):
            poc = p.POC[i]
            poc.tile, poc.resno0, poc.compno0 = 1, r0, c0
            poc.layno1, poc.resno1, poc.compno1 = l1, r1, c1
            poc.prg1 = PROGRESSIONS[order]
            poc.progorder = order.encode()
        p.numpocs = len(pocs)
        if tile_parts:
            p.tp_on, p.tp_flag = b"\x01", tile_parts.encode()
        if roi:
            p.roi_compno, p.roi_shift = roi
        if custom_mct is not None:
            matrix = np.ascontiguousarray(custom_mct[0], np.float32)
            shift = np.ascontiguousarray(custom_mct[1], np.int32)
            assert matrix.shape == (n, n) and shift.shape == (n,)
            if not lib.opj_set_MCT(ctypes.byref(p), matrix.ctypes.data,
                                   shift.ctypes.data, n):
                raise ValueError("opj_set_MCT failed")
        codec = lib.opj_create_compress(2 if jp2 else 0)
        _messages.clear()
        lib.opj_set_error_handler(codec, _on_message, None)
        lib.opj_set_warning_handler(codec, _on_message, None)
        try:
            if not lib.opj_setup_encoder(codec, ctypes.byref(p), image):
                raise ValueError(f"opj_setup_encoder failed: {_messages}")
            extra = [o for o, on in (("PLT=YES", plt), ("TLM=YES", tlm)) if on]
            if extra:
                arr = (ctypes.c_char_p * (len(extra) + 1))(
                    *[o.encode() for o in extra], None)
                if not lib.opj_encoder_set_extra_options(codec, arr):
                    raise ValueError(f"extra options refused: {_messages}")
            fd, path = tempfile.mkstemp(suffix=".jp2" if jp2 else ".j2k")
            os.close(fd)
            try:
                stream = lib.opj_stream_create_default_file_stream(
                    path.encode(), 0)
                try:
                    ok = (lib.opj_start_compress(codec, image, stream)
                          and lib.opj_encode(codec, stream)
                          and lib.opj_end_compress(codec, stream))
                finally:
                    lib.opj_stream_destroy(stream)
                if not ok:
                    raise ValueError(f"OpenJPEG's encoder failed: "
                                     f"{_messages}")
                data = Path(path).read_bytes()
            finally:
                os.unlink(path)
        finally:
            lib.opj_destroy_codec(codec)
            if p.mct_data:
                ctypes.CDLL(None).free(ctypes.c_void_p(p.mct_data))
    finally:
        lib.opj_image_destroy(image)
    _check_markers(data, mode, pocs, roi)
    return data


def markers(data: bytes):
    """[(marker, body)] of a codestream's main header (from SIZ) and its
    first tile-part header (from SOT to SOD), the codestream found after a
    JP2's jp2c box header."""
    i = data.find(b"\xff\x4f\xff\x51")
    assert i >= 0
    i += 2
    out = []
    while True:
        m = struct.unpack(">H", data[i:i + 2])[0]
        if m == 0xFF93:
            return out
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        out.append((m, data[i + 4:i + 2 + n]))
        i += 2 + n


def _check_markers(data: bytes, mode: int, pocs, roi) -> None:
    ms = dict(markers(data))
    assert ms[0xFF52][8] == mode, ("COD style byte", ms[0xFF52][8], mode)
    if pocs:
        body = ms[0xFF5F]
        assert len(body) == 7 * len(pocs), body
        for k, (r0, c0, l1, r1, c1, order) in enumerate(pocs):
            got = struct.unpack(">BBHBBB", body[7 * k:7 * k + 7])
            assert got[0] == r0 and got[1] == c0 and got[5] == PROGRESSIONS[
                order], (got, pocs[k])
    if roi:
        body = ms[0xFF5E]
        assert body[0] == roi[0] and body[2] == roi[1], (body, roi)


# ------------------------------------------------------------- byte edits

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_file(codestream: bytes, height: int, width: int, nc: int,
             bpc: int = 7, enumcs: Optional[int] = 16, extra: bytes = b"",
             meth: int = 1, brand: bytes = b"jp2 ") -> bytes:
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr, a colr
    box of `meth` and `enumcs` unless enumcs is None, then `extra` boxes)
    and jp2c."""
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", height, width, nc, bpc, 7,
                                     0, 0))
    colr = b"" if enumcs is None else _box(
        b"colr", struct.pack(">BBBI", meth, 0, 0, enumcs))
    return (_box(b"jP  ", b"\r\n\x87\n")
            + _box(b"ftyp", brand + bytes(4) + brand)
            + _box(b"jp2h", ihdr + colr + extra) + _box(b"jp2c", codestream))


def pclr_box(entries, depths) -> bytes:
    """A pclr box: `entries` tuples of one byte a column."""
    body = struct.pack(">HB", len(entries), len(depths)) + bytes(depths)
    return _box(b"pclr", body + b"".join(bytes(e) for e in entries))


def cmap_box(columns: int) -> bytes:
    return _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                  for i in range(columns)))


def cdef_box(entries) -> bytes:
    """A cdef box of (channel, type, association) entries."""
    return _box(b"cdef", struct.pack(">H", len(entries)) + b"".join(
        struct.pack(">HHH", *e) for e in entries))


def _tile_parts(cs: bytes):
    """(main header, [(SOT body, tile-part header markers, data)], tail)"""
    first = cs.find(b"\xff\x90")
    main = cs[:first]
    parts, i = [], first
    while cs[i:i + 2] == b"\xff\x90":
        psot = struct.unpack(">I", cs[i + 6:i + 10])[0]
        sot = cs[i + 4:i + 12]
        end = i + psot
        j = i + 12
        head = b""
        while cs[j:j + 2] != b"\xff\x93":
            n = struct.unpack(">H", cs[j + 2:j + 4])[0]
            head += cs[j:j + 2 + n]
            j += 2 + n
        parts.append((sot, head, cs[j + 2:end]))
        i = end
    return main, parts, cs[i:]


def _split_packets(data: bytes):
    """[(SOP, header with its EPH, body)] of tile-part data written with
    SOP and EPH markers (0xFF91 never occurs inside a packet)."""
    out = []
    starts = [k for k in range(len(data) - 1) if data[k:k + 2] == b"\xff\x91"]
    for a, b in zip(starts, starts[1:] + [len(data)]):
        pkt = data[a:b]
        e = pkt.find(b"\xff\x92", 6) + 2
        out.append((pkt[:6], pkt[6:e], pkt[e:]))
    return out


def _sot(body: bytes, length: int) -> bytes:
    return b"\xff\x90\x00\x0a" + body[:2] + struct.pack(">I", length) + \
        body[6:8]


def packed_headers(cs: bytes, where: str = "ppt",
                   chunk: int = 40) -> bytes:
    """A codestream written with SOP and EPH markers, its packet headers
    moved out of the tile data: into each tile-part's PPT markers (Zppt
    numbered on across a tile's parts), or into the main header's PPM
    markers (each tile-part's Nppm field and headers starting a marker,
    headers past `chunk` bytes going on in the next markers)."""
    main, parts, tail = _tile_parts(cs)
    out_parts = []
    ppm = []
    zppt = {}
    for sot, head, data in parts:
        packets = _split_packets(data)
        headers = b"".join(h for _, h, _ in packets)
        bodies = b"".join(s + b for s, _, b in packets)
        if where == "ppt":
            tile = sot[:2]
            markers_ = b""
            for k in range(0, max(len(headers), 1), chunk):
                z = zppt.get(tile, 0)
                zppt[tile] = z + 1
                piece = bytes([z]) + headers[k:k + chunk]
                markers_ += b"\xff\x61" + struct.pack(">H", len(piece) + 2) + \
                    piece
            head = head + markers_
        else:
            first = struct.pack(">I", len(headers)) + headers[:chunk]
            ppm.append(first)
            ppm += [headers[k:k + chunk] for k in range(chunk, len(headers),
                                                         chunk)]
        body = head + b"\xff\x93" + bodies
        out_parts.append(_sot(sot, 12 + len(body)) + body)
    if where == "ppm":
        main = main + b"".join(
            b"\xff\x60" + struct.pack(">H", len(piece) + 3) + bytes([z]) + piece
            for z, piece in enumerate(ppm))
    return main + b"".join(out_parts) + tail
