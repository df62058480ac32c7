"""Image IO: PNG and OpenEXR codecs written against the file formats, PPM.

Replaces the reference's `sutil::loadImage` / `sutil::saveImage` (used at
reference optixSphere.cpp:359, 836, 1489).  The reference loads 8-bit PNG
textures (converted to float4 by /255, cpp:366-380) and float EXR
environment maps.

The PNG codec (stdlib zlib + numpy) follows the PNG specification:
non-interlaced 8- and 16-bit gray, gray+alpha, RGB, RGBA and 8-bit
palette images, every scanline filter.  Other LDR formats (JPEG, ...) go
through Pillow when it is installed.

The EXR implementation is written from the public OpenEXR 2.0 file
format specification: scanline images, NO_COMPRESSION / ZIPS / ZIP
(zlib + delta-predictor + two-half deinterleave), HALF / FLOAT / UINT
channels.  That covers every file Blender/Photoshop-era tools produce for
HDR environments (the reference's env1-5.exr are stripped from the repo;
`procedural_hdr` synthesizes test substitutes).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# channels per PNG colour type (0 gray, 2 RGB, 3 palette, 4 gray+alpha, 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: raw [h, 1+stride] -> [h, stride] u8.

    None/Sub/Up rows are reconstructed a row at a time.  Average and
    Paeth depend on the reconstructed left neighbour, so images using
    them are reconstructed along anti-diagonals of (row, pixel): every
    byte on one diagonal depends only on earlier diagonals."""
    ftype = raw[:, 0]
    data = raw[:, 1:].astype(np.int32)
    if np.any(ftype > 4):
        raise ValueError("PNG: invalid scanline filter type")
    out = np.zeros((h, stride), np.int32)
    if not np.any(ftype >= 3):
        prev = np.zeros(stride, np.int32)
        for y in range(h):
            row = data[y]
            if ftype[y] == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1)
            elif ftype[y] == 2:
                row = row + prev
            prev = out[y] = row & 0xFF
        return out.astype(np.uint8)

    width = stride // bpp
    pix = data.reshape(h, width, bpp)
    res = np.zeros((h + 1, width + 1, bpp), np.int32)   # zero row/col pad
    ft = ftype.astype(np.int32)
    for k in range(h + width - 1):
        y = np.arange(max(0, k - width + 1), min(h, k + 1))
        x = k - y
        a = res[y + 1, x]          # left
        b = res[y, x + 1]          # up
        c = res[y, x]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ft[y][:, None]
        pred = np.select(
            [f == 1, f == 2, f == 3, f == 4],
            [a, b, (a + b) >> 1, paeth],
            0,
        )
        res[y + 1, x + 1] = (pix[y, x] + pred) & 0xFF
    return res[1:, 1:].reshape(h, stride).astype(np.uint8)


def load_png(path: str) -> np.ndarray:
    """Decode a PNG to uint8 [H,W,C] (C = 1, 2, 3 or 4 as stored; palette
    images expand to RGB or RGBA; 16-bit samples keep the high byte)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    off, idat, palette, trns, hdr = 8, [], None, None, None
    while off < len(buf):
        (length,) = struct.unpack_from(">I", buf, off)
        kind = buf[off + 4 : off + 8]
        body = buf[off + 8 : off + 8 + length]
        off += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (colour type {ctype}, bit depth "
            f"{depth}, interlace {interlace})"
        )
    if ctype == 3 and depth != 8:
        raise ValueError(f"{path}: unsupported {depth}-bit palette PNG")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    img = _png_unfilter(raw, h, w * bpp, bpp).reshape(h, w, bpp)
    if depth == 16:
        img = img[:, :, 0::2]                 # big-endian: high byte first
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        rgb = palette[img[:, :, 0]]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns)] = trns
            rgb = np.concatenate([rgb, alpha[img[:, :, 0]][..., None]], -1)
        img = rgb
    return np.ascontiguousarray(img)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode_png(rgb_u8: np.ndarray, level: int = 6) -> bytes:
    """[H,W,3] uint8 (row 0 = top) -> 8-bit RGB PNG bytes (Up filter)."""
    img = np.ascontiguousarray(rgb_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PNG encoder wants [H,W,3] uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3)
    up = np.empty_like(rows)
    up[0] = rows[0]
    up[1:] = rows[1:] - rows[:-1]             # uint8 wraps mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _PNG_SIG
        + _png_chunk(b"IHDR", hdr)
        + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _png_chunk(b"IEND", b"")
    )


def save_png(path: str, rgb_u8: np.ndarray) -> None:
    """Save [H,W,3] uint8 (row 0 = top) as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb_u8))


def load_image(path: str) -> np.ndarray:
    """Load an image as float32 [H,W,3] in [0,1] (u8/255 like the
    reference's texture conversion, cpp:366-380).  EXR goes to load_exr,
    PNG to load_png; other formats need Pillow."""
    p = str(path).lower()
    if p.endswith(".exr"):
        return load_exr(path)
    if p.endswith(".png"):
        img = load_png(path)
        if img.shape[2] in (1, 2):            # gray (+alpha) -> RGB
            img = np.repeat(img[:, :, :1], 3, axis=2)
        return img[:, :, :3].astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: only PNG and EXR are read without Pillow"
        ) from e
    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def save_ppm(path: str, rgb_u8: np.ndarray) -> None:
    h, w = rgb_u8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb_u8).tobytes())


def save_image(path: str, rgb_u8: np.ndarray) -> None:
    """PNG or PPM by extension (sutil::saveImage equivalent, cpp:1489)."""
    p = str(path).lower()
    if p.endswith(".ppm"):
        save_ppm(path, rgb_u8)
    elif p.endswith(".exr"):
        save_exr(path, rgb_u8.astype(np.float32))
    else:
        save_png(path, rgb_u8)


# ---------------------------------------------------------------------------
# OpenEXR scanline codec (subset: what HDR environment maps actually use)
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PT_BYTES = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
# compression ids
_NO_COMP, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_NO_COMP: 1, _ZIPS: 1, _ZIP: 16}


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _exr_unpredict(data: bytes) -> bytes:
    """Invert ZIP post-deflate transform: delta-decode, then deinterleave."""
    arr = np.frombuffer(data, np.uint8).astype(np.int16)
    # delta decode: d[i] += d[i-1] - 128 (sequential; use cumsum)
    deltas = arr.copy()
    deltas[1:] = (arr[1:] - 128).astype(np.int16)
    out = np.cumsum(deltas, dtype=np.int64).astype(np.uint8)
    # deinterleave: first half -> even bytes, second half -> odd bytes
    n = len(out)
    half = (n + 1) // 2
    result = np.empty(n, np.uint8)
    result[0::2] = out[:half]
    result[1::2] = out[half:]
    return result.tobytes()


def _exr_predict(data: bytes) -> bytes:
    """Forward ZIP pre-deflate transform (interleave + delta-encode)."""
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    out = inter.astype(np.int16)
    out[1:] = (inter[1:].astype(np.int16) - inter[:-1].astype(np.int16) + 128)
    return out.astype(np.uint8).tobytes()


def load_exr(path: str) -> np.ndarray:
    """Read a scanline EXR; returns float32 [H,W,3] (R,G,B; missing channels
    filled with the luminance channel or zeros)."""
    with open(path, "rb") as f:
        buf = f.read()

    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    off = 8

    # --- parse header attributes ---
    channels = []  # list of (name, pixel_type)
    compression = _NO_COMP
    data_window = None
    while True:
        name, off = _read_cstr(buf, off)
        if name == "":
            break
        atype, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        payload = buf[off : off + size]
        off += size
        if name == "channels" and atype == "chlist":
            p = 0
            while payload[p] != 0:
                cname, p = _read_cstr(payload, p)
                # entry: pixelType i32, pLinear u8 + 3 reserved, xSampling
                # i32, ySampling i32 = 16 bytes
                (ptype,) = struct.unpack_from("<i", payload, p)
                p += 16
                channels.append((cname, ptype))
            # chlist is stored alphabetically already, but be safe:
            channels.sort(key=lambda c: c[0])
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)

    if data_window is None or not channels:
        raise ValueError(f"{path}: missing required EXR attributes")
    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported EXR compression {compression}")

    xmin, ymin, xmax, ymax = data_window
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    lines_per_block = _LINES_PER_BLOCK[compression]
    num_blocks = (height + lines_per_block - 1) // lines_per_block

    # --- scanline offset table ---
    offsets = struct.unpack_from("<%dQ" % num_blocks, buf, off)

    per_line_bytes = sum(width * _PT_BYTES[pt] for _, pt in channels)
    chan_data: Dict[str, np.ndarray] = {
        cname: np.zeros((height, width), np.float32) for cname, _ in channels
    }

    for block_off in offsets:
        y, size = struct.unpack_from("<ii", buf, block_off)
        raw = buf[block_off + 8 : block_off + 8 + size]
        n_lines = min(lines_per_block, ymax - y + 1)
        expect = per_line_bytes * n_lines
        if compression in (_ZIPS, _ZIP):
            if size < expect:  # compressed only when it helps (spec)
                raw = _exr_unpredict(zlib.decompress(raw))
        p = 0
        for line in range(n_lines):
            yy = y - ymin + line
            for cname, ptype in channels:
                nbytes = width * _PT_BYTES[ptype]
                vals = np.frombuffer(raw, _PT_DTYPE[ptype], count=width, offset=p)
                chan_data[cname][yy] = vals.astype(np.float32)
                p += nbytes

    def pick(*names):
        for n in names:
            if n in chan_data:
                return chan_data[n]
        return None

    r = pick("R", "Y")
    g = pick("G", "Y")
    b = pick("B", "Y")
    zero = np.zeros((height, width), np.float32)
    return np.stack([x if x is not None else zero for x in (r, g, b)], axis=-1)


def save_exr(path: str, rgb: np.ndarray, compression: int = _ZIP) -> None:
    """Write float32 [H,W,3] as scanline EXR (FLOAT channels, ZIP)."""
    rgb = np.asarray(rgb, np.float32)
    h, w = rgb.shape[:2]

    def attr(name: str, atype: str, payload: bytes) -> bytes:
        return (
            name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload
        )

    # channels: B, G, R (alphabetical), FLOAT
    chlist = b""
    for cname in (b"B", b"G", b"R"):
        # pixelType i32, pLinear u8 + 3 reserved, xSampling i32, ySampling i32
        chlist += cname + b"\x00" + struct.pack("<i4Bii", _PT_FLOAT, 0, 0, 0, 0, 1, 1)
    chlist += b"\x00"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([compression]))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    lines_per_block = _LINES_PER_BLOCK[compression]
    num_blocks = (h + lines_per_block - 1) // lines_per_block

    blocks = []
    for bi in range(num_blocks):
        y0 = bi * lines_per_block
        n_lines = min(lines_per_block, h - y0)
        parts = []
        for line in range(n_lines):
            row = rgb[y0 + line]
            for ci in (2, 1, 0):  # B, G, R order
                parts.append(row[:, ci].astype("<f4").tobytes())
        raw = b"".join(parts)
        if compression in (_ZIPS, _ZIP):
            comp = zlib.compress(_exr_predict(raw))
            data = comp if len(comp) < len(raw) else raw
        else:
            data = raw
        blocks.append((y0, data))

    base = 8 + len(header) + 8 * num_blocks
    out = [struct.pack("<ii", _EXR_MAGIC, 2), header]
    offsets = []
    pos = base
    for y0, data in blocks:
        offsets.append(pos)
        pos += 8 + len(data)
    out.append(struct.pack("<%dQ" % num_blocks, *offsets))
    for y0, data in blocks:
        out.append(struct.pack("<ii", y0, len(data)))
        out.append(data)
    with open(path, "wb") as f:
        f.write(b"".join(out))


# ---------------------------------------------------------------------------
# Procedural HDR environments (substitutes for the stripped env1-5.exr)
# ---------------------------------------------------------------------------


def procedural_hdr(
    height: int = 256,
    width: int = 512,
    sun_dir=(0.0, 2.0, 3.0),
    sun_intensity: float = 200.0,
    seed: int = 0,
) -> np.ndarray:
    """Synthesize an equirect HDR: gradient sky + warm sun disc + ground.

    Stands in for the reference's stripped env1-5.exr assets
    (.MISSING_LARGE_BLOBS); intensity scale mirrors the procedural sun+sky
    in the miss program (reference optixSphere.cu:552-557)."""
    v, u = np.meshgrid(
        (np.arange(height) + 0.5) / height,
        (np.arange(width) + 0.5) / width,
        indexing="ij",
    )
    phi = (u - 0.5) * 2.0 * np.pi
    theta = (0.5 - v) * np.pi
    y = np.sin(theta)
    c = np.cos(theta)
    dirs = np.stack([c * np.cos(phi), y, c * np.sin(phi)], axis=-1)

    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    cos_sun = dirs @ sd

    horizon = np.array([0.55, 0.6, 0.7])
    zenith = np.array([0.15, 0.25, 0.5])
    tsky = np.clip(y, 0.0, 1.0)[..., None]
    sky = horizon + (zenith - horizon) * tsky
    ground = np.array([0.25, 0.2, 0.15]) * (1.0 + 0.3 * np.clip(-y, 0, 1))[..., None]
    img = np.where(y[..., None] >= 0.0, sky, ground)

    sun_col = np.array([1.0, 0.875, 0.625]) * sun_intensity
    disc = np.clip((cos_sun - 0.995) / 0.005, 0.0, 1.0) ** 2
    img = img + disc[..., None] * sun_col
    # mild warm glow around the sun
    glow = np.clip(cos_sun, 0.0, 1.0) ** 32
    img = img + glow[..., None] * np.array([1.5, 1.0, 0.5])

    rs = np.random.RandomState(seed)
    img *= 1.0 + 0.02 * rs.randn(height, width, 1)
    return np.maximum(img, 0.0).astype(np.float32)
