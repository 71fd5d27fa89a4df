"""Image files without OpenCV.

PNG is written and read here with the standard library's ``zlib`` and numpy:
8-bit grey and RGB out; 8-bit grey, grey + alpha, RGB and RGBA in (alpha is
dropped), non-interlaced. JPEG and every other format go through Pillow,
imported inside the function that needs it."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples per pixel, for the 8-bit types read here
_PNG_SAMPLES = {0: 1, 2: 3, 4: 2, 6: 4}


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("PIL (the Pillow package) is needed to read or write this image "
                          "format") from e
    return Image


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, compress_level: int = 3) -> None:
    """Writes a uint8 (H, W) grey or (H, W, 3) RGB image as an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes a uint8 (H, W) or (H, W, 3) image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    # every scanline starts with its filter type: 0, none
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw, compress_level)) + _chunk(b"IEND", b""))


def _png_header(data: bytes):
    """(width, height, bit depth, colour type, interlace) of PNG bytes, or
    None when they are no PNG."""
    if len(data) < 33 or data[:8] != _PNG_SIGNATURE or data[12:16] != b"IHDR":
        return None
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return w, h, depth, ctype, interlace


def _unfilter(lines: np.ndarray, bpp: int) -> np.ndarray:
    """Undoes the PNG scanline filters. ``lines``: (H, 1 + W·bpp) uint8."""
    h = lines.shape[0]
    out = np.zeros((h, lines.shape[1] - 1), np.uint8)
    prev = np.zeros(out.shape[1], np.uint8)
    for y in range(h):
        ftype, cur = int(lines[y, 0]), lines[y, 1:]
        if ftype == 0:
            row = cur
        elif ftype == 1:  # sub: a running sum per sample, modulo 256
            row = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # up
            row = cur + prev
        elif ftype in (3, 4):  # average and Paeth depend on the pixel just decoded
            row = np.zeros_like(cur)
            c, up = cur.tolist(), prev.tolist()
            acc = [0] * len(c)
            for i, v in enumerate(c):
                a = acc[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    cc = up[i - bpp] if i >= bpp else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                acc[i] = (v + pred) & 0xFF
            row = np.asarray(acc, np.uint8)
        else:
            raise ValueError(f"read_png: unknown filter type {ftype}")
        out[y] = row
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Reads an 8-bit non-interlaced PNG: grey comes back (H, W), colour
    (H, W, 3) RGB; an alpha channel is dropped."""
    with open(path, "rb") as f:
        data = f.read()
    head = _png_header(data)
    if head is None:
        raise ValueError(f"read_png: {path} is not a PNG file")
    w, h, depth, ctype, interlace = head
    if depth != 8 or ctype not in _PNG_SAMPLES or interlace:
        raise ValueError(f"read_png: {path}: only 8-bit non-interlaced grey and RGB PNGs are "
                         f"read here (bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace})")
    pos, idat = 8, []
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        elif kind == b"IEND":
            break
        pos += 12 + length
    bpp = _PNG_SAMPLES[ctype]
    lines = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    px = _unfilter(lines, bpp).reshape(h, w, bpp)
    if ctype == 0:
        return px[..., 0]
    if ctype == 4:
        return np.ascontiguousarray(px[..., 0])
    return np.ascontiguousarray(px[..., :3])


def read_image(path: str) -> np.ndarray:
    """Any raster image as RGB uint8 (H, W, 3). The PNGs ``read_png`` reads
    are read by it; every other file goes through Pillow."""
    with open(path, "rb") as f:
        head = _png_header(f.read(33))
    if head is not None and head[2] == 8 and head[3] in _PNG_SAMPLES and not head[4]:
        img = read_png(path)
        return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
    with _pillow().open(path) as im:
        return np.asarray(im.convert("RGB"))


def png_rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """RGB uint8 (H, W, 3) → grey as libpng converts it when OpenCV reads a
    colour PNG as grey (``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``): 15-bit
    coefficients 9797, 19234 and 3737, truncated, and a pixel whose three
    channels are equal kept as it is. This is not ``cv2.cvtColor``'s
    RGB2GRAY (``ops.imgproc.rgb_to_gray_u8``), which rounds: the two differ
    by one level on about half of all pixels."""
    s = img.astype(np.int32)
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    grey = (r == g) & (r == b)
    return np.where(grey, r, (9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """Any raster image as grey uint8 (H, W), as ``cv2.imread(path,
    cv2.IMREAD_GRAYSCALE)`` reads a PNG: grey as stored, colour (alpha
    dropped, a palette expanded) through ``png_rgb_to_gray_u8``."""
    with open(path, "rb") as f:
        head = _png_header(f.read(33))
    if head is not None and head[2] == 8 and head[3] in _PNG_SAMPLES and not head[4]:
        img = read_png(path)
        return img if img.ndim == 2 else png_rgb_to_gray_u8(img)
    with _pillow().open(path) as im:
        if im.mode == "L":
            return np.asarray(im)
        return png_rgb_to_gray_u8(np.asarray(im.convert("RGB")))


def write_jpg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Writes a uint8 RGB (or grey) image as a JPEG, through Pillow."""
    _pillow().fromarray(np.ascontiguousarray(img)).save(path, format="JPEG", quality=quality)


def write_image(path: str, img: np.ndarray) -> None:
    """Writes a uint8 grey or RGB image in the format its extension names, as
    ``cv2.imwrite`` chooses one: ``.png`` by ``write_png``, ``.jpg``/``.jpeg``
    by ``write_jpg``, any other through Pillow."""
    ext = path.lower().rsplit(".", 1)[-1]
    if ext == "png":
        write_png(path, img)
    elif ext in ("jpg", "jpeg"):
        write_jpg(path, img)
    else:
        _pillow().fromarray(np.ascontiguousarray(img)).save(path)
