'''
PNG writer and reader on Python's standard library (zlib, struct) and numpy.

The data plane writes its synthetic scenes and reads RGB, preflat and depth
frames as PNG. The JAX package does so through imageio, PIL and matplotlib;
this module gives the same pixels without them:

  * write_png: 8-bit grey (H, W) and RGB / RGBA (H, W, 3|4) arrays,
    non-interlaced, every row with filter 0;
  * read_png: non-interlaced PNGs of 8 or 16 bits per sample, grey, grey +
    alpha, RGB, RGBA, and 8-bit palettes (expanded to RGBA, as PIL's
    convert('RGBA') does), all five row filters; the samples as uint8 or
    uint16 in an (H, W) or (H, W, C) array;
  * imread: read_png scaled as the data plane reads images, u8 / 255 and
    16-bit / 65535 in float32.
'''

import struct
import zlib

import numpy as np

__all__ = ['write_png', 'read_png', 'imread', 'to_u8']

_SIG = b'\x89PNG\r\n\x1a\n'
# PNG colour type -> samples per pixel.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(kind, data):
    body = kind + data
    return struct.pack('>I', len(data)) + body + struct.pack('>I', zlib.crc32(body))


def to_u8(arr):
    '''A float image in [0, 1] as 8-bit samples: clip, scale by 255 and
    truncate, as the synthetic scenes' `(clip(arr) * 255).astype(uint8)`.'''
    arr = np.clip(np.asarray(arr), 0.0, 1.0)
    return (arr * 255).astype(np.uint8)


def write_png(fp, arr):
    '''Write an (H, W) or (H, W, C) uint8 array (C 1-4) as PNG.'''
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f'write_png takes uint8 samples, not {arr.dtype}')
    if arr.ndim == 2:
        arr = arr[..., None]
    H, W, C = arr.shape
    if C not in _COLOR_TYPE:
        raise ValueError(f'write_png takes 1 to 4 channels, not {C}')
    rows = np.ascontiguousarray(arr).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack('>IIBBBBB', W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    data = (_SIG + _chunk(b'IHDR', ihdr)
            + _chunk(b'IDAT', zlib.compress(raw.tobytes())) + _chunk(b'IEND', b''))
    with open(fp, 'wb') as f:
        f.write(data)


def _paeth_row(raw, prior, bpp):
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _avg_row(raw, prior, bpp):
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(data, H, stride, bpp):
    '''Undo the per-row filters of the inflated stream: (H, stride) uint8.'''
    if len(data) < H * (stride + 1):
        raise ValueError('PNG image data is truncated')
    rows = np.frombuffer(data, np.uint8, H * (stride + 1)).reshape(H, stride + 1)
    filters, raw = rows[:, 0], rows[:, 1:]
    if not filters.any():
        return raw.copy()
    out = np.empty((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(H):
        f, x = int(filters[r]), raw[r]
        if f == 0:
            cur = x
        elif f == 1:      # Sub: a running sum of each sample of the pixel, mod 256.
            cur = np.empty(stride, np.uint8)
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(x[k::bpp], dtype=np.uint8)
        elif f == 2:      # Up.
            cur = x + prior
        elif f == 3:      # Average.
            cur = np.frombuffer(bytes(_avg_row(x.tobytes(), prior.tobytes(), bpp)), np.uint8)
        elif f == 4:      # Paeth.
            cur = np.frombuffer(bytes(_paeth_row(x.tobytes(), prior.tobytes(), bpp)),
                                np.uint8)
        else:
            raise ValueError(f'PNG row filter {f} is not defined')
        out[r] = cur
        prior = out[r]
    return out


def read_png(fp):
    '''
    :return (H, W) or (H, W, C) uint8 / uint16 samples. Palettes expand to
        RGBA (alpha from tRNS, else 255).
    :raise ValueError on a corrupt or unsupported file (interlaced, or fewer
        than 8 bits per sample).
    '''
    with open(fp, 'rb') as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError(f'{fp}: not a PNG file')
    pos, idat, plte, trns, hdr = 8, [], None, None, None
    while pos + 12 <= len(buf):
        (n,) = struct.unpack('>I', buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        if len(data) != n:
            raise ValueError(f'{fp}: truncated chunk {kind!r}')
        pos += 12 + n
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', data)
        elif kind == b'IDAT':
            idat.append(data)
        elif kind == b'PLTE':
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b'tRNS':
            trns = np.frombuffer(data, np.uint8)
        elif kind == b'IEND':
            break
    if hdr is None or not idat:
        raise ValueError(f'{fp}: no IHDR or IDAT chunk')
    W, H, bits, ctype, _, _, interlace = hdr
    if interlace or bits not in (8, 16) or ctype not in _CHANNELS \
            or (ctype == 3 and bits != 8):
        raise ValueError(f'{fp}: unsupported PNG (bits {bits}, colour type {ctype}, '
                         f'interlace {interlace})')
    C = _CHANNELS[ctype]
    bpp = C * bits // 8
    px = _unfilter(zlib.decompress(b''.join(idat)), H, W * bpp, bpp)
    if bits == 16:
        px = px.view('>u2').astype(np.uint16)
    px = px.reshape(H, W, C)
    if ctype == 3:
        if plte is None:
            raise ValueError(f'{fp}: palette image without PLTE')
        alpha = np.full(len(plte), 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = trns[:len(plte)]
        lut = np.concatenate([plte, alpha[:, None]], axis=1)
        return lut[px[..., 0]]
    return px[..., 0] if C == 1 else px


def imread(fp):
    '''PNG -> float32 array in [0, 1]: u8 / 255, 16-bit / 65535.'''
    arr = read_png(fp)
    scale = 255.0 if arr.dtype == np.uint8 else 65535.0
    return arr.astype(np.float32) / scale
