"""GROMACS XTC trajectory IO (XDR + 3dfcoord compression).

A copy of codlad_tpu/data/xtc.py for the port: the frame framing and header
parsing here, the bit codec in the port's native library
(codlad_tpu_torch/native.py, csrc/native_host.cpp) with the same pure-Python
fallback codec. Files written through the native codec are byte for byte
those of the JAX package's native codec.

The reference ingests Atlas xtc trios through mdtraj (reference:
utils/protein_module.py:898 — stride 100 at train preprocessing;
utils/dataset_module.py:148-160 — stride 10000 at test time) and dumps
generated ensembles back to xtc (test.py:787-803).  This module provides
both directions without mdtraj (the public-domain GROMACS xdrfile
algorithm reimplemented; full decoder incl. run-length water packing and
adaptive smallidx).

Coordinates are nm in the file (GROMACS convention); `read_xtc` returns
them as stored — callers convert to Å (x10) exactly like the reference's
mdtraj path does (protein_module.py:523).

Strided reads stay cheap: non-selected frames are skipped by seeking past
their compressed payload without decoding.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from codlad_tpu_torch import native

_MAGIC = 1995

MAGICINTS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384,
    20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072,
    165140, 208063, 262144, 330280, 416127, 524287, 660561, 832255,
    1048576, 1321122, 1664510, 2097152, 2642245, 3329021, 4194304,
    5284491, 6658042, 8388607, 10568983, 13316085, 16777216]
FIRSTIDX = 9
LASTIDX = len(MAGICINTS) - 1


# ------------------------------------------------------------ pure-Python
# codec fallback (same algorithm as the native kernels; slow but complete)

class _BitReader:
    def __init__(self, data):
        self.data = data
        self.cnt = 0
        self.lastbits = 0
        self.lastbyte = 0

    def bits(self, nbits):
        num = 0
        mask = (1 << nbits) - 1
        d = self.data
        while nbits >= 8:
            self.lastbyte = (self.lastbyte << 8) | d[self.cnt]
            self.cnt += 1
            num |= (self.lastbyte >> self.lastbits) << (nbits - 8)
            nbits -= 8
        if nbits > 0:
            if self.lastbits < nbits:
                self.lastbits += 8
                self.lastbyte = (self.lastbyte << 8) | d[self.cnt]
                self.cnt += 1
            self.lastbits -= nbits
            num |= (self.lastbyte >> self.lastbits) & ((1 << nbits) - 1)
        return num & mask

    def ints(self, num_of_bits, sizes):
        bytes_ = [0, 0, 0, 0]
        n = 0
        while num_of_bits > 8:
            if n < len(bytes_):
                bytes_[n] = self.bits(8)
            else:
                bytes_.append(self.bits(8))
            n += 1
            num_of_bits -= 8
        if num_of_bits > 0:
            if n < len(bytes_):
                bytes_[n] = self.bits(num_of_bits)
            else:
                bytes_.append(self.bits(num_of_bits))
            n += 1
        nums = [0, 0, 0]
        for i in (2, 1):
            num = 0
            for j in range(n - 1, -1, -1):
                num = (num << 8) | bytes_[j]
                p = num // sizes[i]
                bytes_[j] = p
                num -= p * sizes[i]
            nums[i] = num
        nums[0] = bytes_[0] | (bytes_[1] << 8) | (bytes_[2] << 16) | (bytes_[3] << 24)
        return nums


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.lastbits = 0
        self.lastbyte = 0

    def bits(self, nbits, num):
        while nbits >= 8:
            self.lastbyte = ((self.lastbyte << 8) | ((num >> (nbits - 8)) & 0xFF))
            self.out.append((self.lastbyte >> self.lastbits) & 0xFF)
            nbits -= 8
        if nbits > 0:
            self.lastbyte = (self.lastbyte << nbits) | (num & ((1 << nbits) - 1))
            self.lastbits += nbits
            if self.lastbits >= 8:
                self.lastbits -= 8
                self.out.append((self.lastbyte >> self.lastbits) & 0xFF)

    def ints(self, num_of_bits, sizes, nums):
        bytes_ = []
        tmp = nums[0]
        while True:
            bytes_.append(tmp & 0xFF)
            tmp >>= 8
            if tmp == 0:
                break
        for i in (1, 2):
            tmp = nums[i]
            for bc in range(len(bytes_)):
                tmp += bytes_[bc] * sizes[i]
                bytes_[bc] = tmp & 0xFF
                tmp >>= 8
            while tmp != 0:
                bytes_.append(tmp & 0xFF)
                tmp >>= 8
        if num_of_bits >= len(bytes_) * 8:
            for b in bytes_:
                self.bits(8, b)
            self.bits(num_of_bits - len(bytes_) * 8, 0)
        else:
            for b in bytes_[:-1]:
                self.bits(8, b)
            self.bits(num_of_bits - (len(bytes_) - 1) * 8, bytes_[-1])

    def flush(self):
        if self.lastbits > 0:
            self.out.append((self.lastbyte << (8 - self.lastbits)) & 0xFF)
            self.lastbits = 0


def _sizeofint(size):
    num, nbits = 1, 0
    while size >= num and nbits < 32:
        nbits += 1
        num <<= 1
    return nbits


def _sizeofints(sizes):
    bytes_ = [1]
    for s in sizes:
        tmp = 0
        for bc in range(len(bytes_)):
            tmp += bytes_[bc] * s
            bytes_[bc] = tmp & 0xFF
            tmp >>= 8
        while tmp != 0:
            bytes_.append(tmp & 0xFF)
            tmp >>= 8
    num, nbits = 1, 0
    while bytes_[-1] >= num:
        nbits += 1
        num *= 2
    return nbits + (len(bytes_) - 1) * 8


def _decode_frame_py(data, natoms, minint, maxint, smallidx, precision):
    sizeint = [maxint[d] - minint[d] + 1 for d in range(3)]
    if any(s > 0xFFFFFF for s in sizeint):
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsize = _sizeofints(sizeint)
    smallnum = MAGICINTS[smallidx] // 2
    sizesmall = [MAGICINTS[smallidx]] * 3
    smaller = MAGICINTS[max(FIRSTIDX, smallidx - 1)] // 2
    inv = 1.0 / precision

    br = _BitReader(data)
    out = np.empty((natoms, 3), np.float32)
    run = 0
    i = e = 0
    prev = [0, 0, 0]
    while i < natoms:
        if bitsize == 0:
            this = [br.bits(bitsizeint[d]) for d in range(3)]
        else:
            this = br.ints(bitsize, sizeint)
        i += 1
        this = [this[d] + minint[d] for d in range(3)]
        prev = list(this)
        flag = br.bits(1)
        is_smaller = 0
        if flag == 1:
            run = br.bits(5)
            is_smaller = run % 3
            run -= is_smaller
            is_smaller -= 1
        if run > 0:
            for k in range(0, run, 3):
                this = br.ints(smallidx, sizesmall)
                i += 1
                this = [this[d] + prev[d] - smallnum for d in range(3)]
                if k == 0:
                    this, prev = prev, this
                    out[e] = [prev[d] * inv for d in range(3)]
                    e += 1
                else:
                    prev = list(this)
                out[e] = [this[d] * inv for d in range(3)]
                e += 1
        else:
            out[e] = [this[d] * inv for d in range(3)]
            e += 1
        smallidx += is_smaller
        if is_smaller < 0:
            smallnum = smaller
            smaller = MAGICINTS[smallidx - 1] // 2 if smallidx > FIRSTIDX else 0
        elif is_smaller > 0:
            smaller = smallnum
            smallnum = MAGICINTS[smallidx] // 2
        sizesmall = [MAGICINTS[smallidx]] * 3
    return out


def _encode_frame_py(xyz, precision):
    """Simple conformant encoder (no run packing: flag=0 everywhere after an
    initial run reset).  Any spec-correct decoder accepts it; used as a
    cross-check against the native adaptive encoder."""
    ip = np.where(xyz * precision >= 0, xyz * precision + 0.5,
                  xyz * precision - 0.5).astype(np.int64)
    minint = ip.min(0).tolist()
    maxint = ip.max(0).tolist()
    sizeint = [maxint[d] - minint[d] + 1 for d in range(3)]
    if any(s > 0xFFFFFF for s in sizeint):
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsize = _sizeofints(sizeint)
    smallidx = FIRSTIDX
    bw = _BitWriter()
    first = True
    for a in range(ip.shape[0]):
        tc = [int(ip[a, d] - minint[d]) for d in range(3)]
        if bitsize == 0:
            for d in range(3):
                bw.bits(bitsizeint[d], tc[d])
        else:
            bw.ints(bitsize, sizeint, tc)
        if first:
            # explicit run=0 marker so the decoder's persistent run resets
            bw.bits(1, 1)
            bw.bits(5, 0 + 0 + 1)
            first = False
        else:
            bw.bits(1, 0)
    bw.flush()
    return bytes(bw.out), minint, maxint, smallidx


# --------------------------------------------------------------- framing

def _read_exact(f, n):
    b = f.read(n)
    if len(b) != n:
        raise EOFError
    return b


def read_xtc(path, stride=1, max_frames=None):
    """Read an xtc file.

    Returns dict with xyz [T, N, 3] float32 (nm, as stored), time [T],
    step [T] and box [T, 3, 3].  `stride` skips frames WITHOUT decoding
    them (payload seek), mirroring the reference's mdtraj stride usage.
    """
    xyzs, times, steps, boxes = [], [], [], []
    frame = 0
    with open(path, "rb") as f:
        while True:
            try:
                hdr = _read_exact(f, 16)
            except EOFError:
                break
            magic, natoms, step, = struct.unpack(">iii", hdr[:12])
            (time,) = struct.unpack(">f", hdr[12:])
            if magic != _MAGIC:
                raise ValueError(f"{path}: bad xtc magic {magic} at frame {frame}")
            box = np.frombuffer(_read_exact(f, 36), ">f4").reshape(3, 3)
            (lsize,) = struct.unpack(">i", _read_exact(f, 4))
            if lsize != natoms:
                raise ValueError(f"{path}: natoms mismatch {natoms} vs {lsize}")
            want = frame % stride == 0 and (
                max_frames is None or len(xyzs) < max_frames)
            if natoms <= 9:
                raw = _read_exact(f, 12 * natoms)
                if want:
                    xyz = np.frombuffer(raw, ">f4").reshape(natoms, 3).astype(
                        np.float32)
            else:
                sub = _read_exact(f, 36)
                precision = struct.unpack(">f", sub[:4])[0]
                ints = np.frombuffer(sub[4:32], ">i4")
                minint, maxint = ints[:3].tolist(), ints[3:6].tolist()
                smallidx = int(ints[6])
                (nbytes,) = struct.unpack(">i", sub[32:])
                padded = (nbytes + 3) // 4 * 4
                if want:
                    data = _read_exact(f, padded)[:nbytes]
                    xyz = _decode_payload(data, natoms, minint, maxint,
                                          smallidx, precision)
                else:
                    f.seek(padded, os.SEEK_CUR)
            if want:
                xyzs.append(xyz)
                times.append(time)
                steps.append(step)
                boxes.append(box)
            frame += 1
            if (max_frames is not None and len(xyzs) >= max_frames
                    and stride == 1):
                break
    if not xyzs:
        raise ValueError(f"{path}: no frames read")
    return {"xyz": np.stack(xyzs), "time": np.asarray(times, np.float32),
            "step": np.asarray(steps, np.int32), "box": np.stack(boxes)}


def _decode_payload(data, natoms, minint, maxint, smallidx, precision):
    out = native.xtc_decode(data, natoms, minint, maxint, smallidx, precision)
    if out is not None:
        return out
    return _decode_frame_py(data, natoms, minint, maxint, smallidx, precision)


def write_xtc(path, xyz, time=None, step=None, box=None, precision=1000.0):
    """Write [T, N, 3] coordinates (nm) as xtc."""
    xyz = np.asarray(xyz, np.float32)
    T, N = xyz.shape[:2]
    time = np.zeros(T, np.float32) if time is None else np.asarray(time)
    step = np.arange(T, dtype=np.int32) if step is None else np.asarray(step)
    if box is None:
        box = np.zeros((T, 3, 3), np.float32)
    with open(path, "wb") as f:
        for t in range(T):
            f.write(struct.pack(">iii", _MAGIC, N, int(step[t])))
            f.write(struct.pack(">f", float(time[t])))
            f.write(np.asarray(box[t], ">f4").tobytes())
            f.write(struct.pack(">i", N))
            if N <= 9:
                f.write(np.asarray(xyz[t], ">f4").tobytes())
                continue
            enc = native.xtc_encode(xyz[t], precision)
            if enc is None:
                data, minint, maxint, smallidx = _encode_frame_py(
                    xyz[t], precision)
            else:
                data, minint, maxint, smallidx = enc
            f.write(struct.pack(">f", float(precision)))
            f.write(np.asarray(minint + maxint, ">i4").tobytes())
            f.write(struct.pack(">i", int(smallidx)))
            f.write(struct.pack(">i", len(data)))
            f.write(data)
            pad = (-len(data)) % 4
            if pad:
                f.write(b"\x00" * pad)
