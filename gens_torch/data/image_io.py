"""Image decoding, resizing and writing on the host, in numpy.

* :func:`read_image`: PNG and JPEG through PIL, imported when called, as
  the JAX readers decode them; the readers need PIL.
* :func:`resize_nearest`: ``cv2.resize(..., interpolation=INTER_NEAREST)``
  bit for bit, so the port needs no cv2.
* :func:`write_png`: an 8-bit grey or RGB PNG through zlib.
* :func:`magma`: matplotlib's magma colour map as ``ScalarMappable`` with
  ``Normalize(vmin, vmax)`` applies it, from an embedded table of its 256
  RGB entries, so the port needs no matplotlib.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def read_image(path: str) -> np.ndarray:
    """The decoded image at ``path`` as float32 (H, W) or (H, W, C)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im, dtype=np.float32)


def resize_nearest(img: np.ndarray, hw) -> np.ndarray:
    """Nearest-neighbour resize of an (H, W) or (H, W, C) array to ``hw``
    = (h, w), as OpenCV's INTER_NEAREST: destination index i reads source
    index min(floor(i * (1 / (dst / src))), src - 1) on each axis, in
    double precision."""
    src_h, src_w = img.shape[:2]
    dst_h, dst_w = int(hw[0]), int(hw[1])

    def index(dst, src):
        inv = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                          src - 1)

    return img[index(dst_h, src_h)[:, None], index(dst_w, src_w)[None, :]]


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) or (H, W, 3) uint8 array as PNG (zlib only)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR",
                      struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# matplotlib's "magma" entries 0..255 as uint8 RGB (its float entries times
# 255, truncated, as ``to_rgba(x)[..., :3] * 255`` then ``astype(uint8)``)
MAGMA = np.frombuffer(bytes.fromhex(
    "00000300000400000601000701010901010b02020d02020f030311040313040415050417"
    "06051907051b08061d09071f0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31"
    "120d33140d35150e38160e3a170f3c180f3f1a10411b10441c10461e10491f114b20114d"
    "2211502311522511552611572811592a115c2b115e2d10602f1062301065321067341068"
    "350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74430f75450f76470f77481078"
    "4a10794b10794d117a4f117b50127b52127c53137c55137d57147d58157e5a157e5b167e"
    "5d177e5e177f60187f61187f63197f651a80661a80681b80691c806b1c806c1d806e1e81"
    "6f1e81711f81731f817420817621817721817922817a22817c23817e24817f2481812581"
    "8225818426818526818727818928818a28818c29808d29808f2a80912a80922b80942b80"
    "952c80972c7f992d7f9a2d7f9c2e7f9e2e7e9f2f7ea12f7ea3307ea4307da6317da7317d"
    "a9327cab337cac337bae347bb0347bb1357ab3357ab53679b63679b83778b93778bb3877"
    "bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070"
    "d0416fd1426ed3426dd4436dd6446cd7456bd9466ada4769dc4869dd4968de4a67e04b66"
    "e14c66e24d65e44e64e55063e65162e75262e85461ea5560eb5660ec585fed595fee5b5e"
    "ee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685bf56a5bf56c5bf66e5bf6705b"
    "f7715bf7735cf8755cf8775cf9795cf97b5df97d5dfa7f5efa805efa825ffb8460fb8660"
    "fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567fd9768fd9969fd9b6afd9d6b"
    "fd9f6cfda16efda26ffda470fea671fea873feaa74feac75feae76feaf78feb179feb37b"
    "feb57cfeb77dfeb97ffebb80febc82febe83fec085fec286fec488fec689fec78bfec98d"
    "fecb8efdcd90fdcf92fdd193fdd295fdd497fdd698fdd89afdda9cfddc9dfddd9ffddfa1"
    "fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fcf1b3fcf3b5fcf5b7"
    "fbf7b9fbf9bbfbfabdfbfcbf"
), np.uint8).reshape(256, 3)


def magma(values: np.ndarray, vmin: float = 0.0, vmax: float = 2.5
          ) -> np.ndarray:
    """(..., 3) uint8 magma colours of ``values`` over [vmin, vmax], as
    ``ScalarMappable(Normalize(vmin, vmax), "magma").to_rgba`` gives them
    (RGB times 255, truncated): the bin is floor of the normalised value
    times 256 in the values' float type, the top edge in the last bin;
    values below the range take the first entry, above it the last, and
    NaN is black."""
    x = np.array(values, dtype=np.result_type(values, np.float32))
    x -= vmin
    x /= vmax - vmin
    x *= 256
    x[x == 256] = 255
    under, over, bad = x < 0, x >= 256, np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = x.astype(np.int64)
    idx[under] = 0
    idx[over] = 255
    idx[bad] = 0
    out = MAGMA[idx]
    out[bad] = 0
    return out
