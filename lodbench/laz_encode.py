"""The LASzip encoder the LAZ writer (formats/laz.py) compresses with: the
program's own (simlod_tpu_torch.native.laz_encode, written from the LAZ
specification), the one LASzip encoder on the machine. It is the only
code of the program that the benchmark's writers call, and it is imported
when a file is written, never when the format module is loaded: the
reference's reader decodes the raw LAS copy written beside the file and
never the program's LAZ.

LASzip codes every chunk on its own (each restarts its models and its
coder), so `encode` compresses the chunks on a pool of one thread per core
(the codec releases the GIL) and writes the chunk table of their sizes
itself: the table's integer compressor and arithmetic coder (LAZ
specification) are written out below, and the stream is the one that a
single call of the encoder over all the records gives, byte for byte."""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# LASzip item types and sizes of point format 2 (LAZ specification)
POINT10, RGB12 = 6, 8
ITEMS = ((POINT10, 20), (RGB12, 6))

M32 = 0xFFFFFFFF
AC_MIN_LENGTH = 1 << 24
BM_SHIFT, BM_MAX = 13, 1 << 13      # bit models
DM_SHIFT, DM_MAX = 15, 1 << 15      # symbol models


def _native_encode(records: np.ndarray, chunk_size: int) -> np.ndarray:
    from simlod_tpu_torch import native
    return native.laz_encode(records, chunk_size, [t for t, _ in ITEMS],
                             [s for _, s in ITEMS])


def encode(records: np.ndarray, chunk_size: int,
           threads: int | None = None) -> np.ndarray:
    """Raw point-format-2 records [n, 26] -> the chunked LASzip stream:
    the 8-byte chunk-table offset (relative to the stream's start), the
    chunks, then the chunk table. The chunks are encoded one a call, on
    `threads` threads (default: one per core)."""
    n = len(records)
    starts = range(0, n, chunk_size)

    def chunk(first):
        s = _native_encode(records[first:first + chunk_size], chunk_size)
        end = int(s[:8].view("<i8")[0])      # the chunk's own table offset
        return s[8:end]
    with ThreadPoolExecutor(threads or os.cpu_count() or 1) as ex:
        chunks = list(ex.map(chunk, starts))
    table = chunk_table([len(c) for c in chunks])
    head = np.array([8 + sum(len(c) for c in chunks)], "<i8").view(np.uint8)
    return np.concatenate([head, *chunks, table])


def chunk_table(sizes) -> np.ndarray:
    """The LASzip chunk table of the chunks' byte sizes: u32 version 0, u32
    the number of chunks, then each size coded by an integer compressor
    (32 bits, 2 contexts, context 1) from the previous one."""
    enc = _Encoder()
    ic = _IntegerCompressor()
    prev = 0
    for s in sizes:
        ic.compress(enc, prev, int(s))
        prev = int(s)
    enc.done()
    head = np.array([0, len(sizes)], "<u4").view(np.uint8)
    return np.concatenate([head, np.frombuffer(bytes(enc.out), np.uint8)])


class _BitModel:
    def __init__(self):
        self.zeros, self.count = 1, 2
        self.prob = 1 << (BM_SHIFT - 1)
        self.cycle = self.until = 4

    def update(self):
        self.count += self.cycle
        if self.count > BM_MAX:
            self.count = (self.count + 1) >> 1
            self.zeros = (self.zeros + 1) >> 1
            if self.zeros == self.count:
                self.count += 1
        self.prob = (self.zeros << BM_SHIFT) // self.count
        self.cycle = min((5 * self.cycle) >> 2, 64)
        self.until = self.cycle


class _Model:
    def __init__(self, symbols: int):
        self.symbols, self.last = symbols, symbols - 1
        self.counts, self.dist = [1] * symbols, [0] * symbols
        self.total, self.cycle = 0, symbols
        self.update()
        self.until = self.cycle = (symbols + 6) >> 1

    def update(self):
        self.total += self.cycle
        if self.total > DM_MAX:
            self.counts = [(c + 1) >> 1 for c in self.counts]
            self.total = sum(self.counts)
        scale, acc = 0x80000000 // self.total, 0
        for k in range(self.symbols):
            self.dist[k] = ((scale * acc) & M32) >> (31 - DM_SHIFT)
            acc += self.counts[k]
        self.cycle = min((5 * self.cycle) >> 2, (self.symbols + 6) << 3)
        self.until = self.cycle


class _Encoder:
    """The arithmetic coder, 32-bit base and length."""

    def __init__(self):
        self.out = bytearray()
        self.base, self.length = 0, M32

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 0xFF:
            self.out[i] = 0
            i -= 1
        if i >= 0:
            self.out[i] += 1

    def _renorm(self):
        while True:
            self.out.append(self.base >> 24)
            self.base = (self.base << 8) & M32
            self.length = (self.length << 8) & M32
            if self.length >= AC_MIN_LENGTH:
                return

    def _add(self, x: int):
        before = self.base
        self.base = (self.base + x) & M32
        if before > self.base:
            self._carry()

    def bit(self, m: _BitModel, bit: int):
        x = m.prob * (self.length >> BM_SHIFT)
        if bit:
            self._add(x)
            self.length -= x
        else:
            self.length = x
            m.zeros += 1
        if self.length < AC_MIN_LENGTH:
            self._renorm()
        m.until -= 1
        if m.until == 0:
            m.update()

    def symbol(self, m: _Model, sym: int):
        if sym == m.last:
            x = m.dist[sym] * (self.length >> DM_SHIFT)
            self._add(x)
            self.length -= x
        else:
            self.length >>= DM_SHIFT
            x = m.dist[sym] * self.length
            self._add(x)
            self.length = m.dist[sym + 1] * self.length - x
        if self.length < AC_MIN_LENGTH:
            self._renorm()
        m.counts[sym] += 1
        m.until -= 1
        if m.until == 0:
            m.update()

    def raw_bits(self, bits: int, sym: int):
        if bits > 19:
            self.raw_bits(16, sym & 0xFFFF)
            self.raw_bits(bits - 16, sym >> 16)
            return
        self.length >>= bits
        self._add(sym * self.length)
        if self.length < AC_MIN_LENGTH:
            self._renorm()

    def done(self):
        """Flush: the stream then holds exactly what the decoder reads."""
        if self.length > 2 * AC_MIN_LENGTH:
            self._add(AC_MIN_LENGTH)
            self.length, tail = AC_MIN_LENGTH >> 1, 3
        else:
            self._add(AC_MIN_LENGTH >> 1)
            self.length, tail = AC_MIN_LENGTH >> 9, 2
        self._renorm()
        for _ in range(tail):
            self.out.append(self.base >> 24)
            self.base = (self.base << 8) & M32


class _IntegerCompressor:
    """32 bits, 2 contexts: a correction's bit count k (a model per
    context), then its value (a model per k, up to 8 high bits, the rest
    raw); 0 and 1 as one bit."""
    BITS_HIGH = 8

    def __init__(self):
        self.m_bits = [_Model(33), _Model(33)]
        self.m_corr0 = _BitModel()
        self.m_corr = {}

    def compress(self, enc: _Encoder, pred: int, real: int, context: int = 1):
        c = (real - pred + (1 << 31)) % (1 << 32) - (1 << 31)   # I32 wrap
        if c == -(1 << 31):
            k = 32
        elif c > 1:
            k = (c - 1).bit_length()
        elif c < 0:
            k = (-c).bit_length()
        else:
            k = 0
        enc.symbol(self.m_bits[context], k)
        if k == 0:
            enc.bit(self.m_corr0, c)
        elif k < 32:
            raw = c - 1 if c > 0 else c + (1 << k) - 1
            m = self.m_corr.get(k)
            if m is None:
                m = self.m_corr[k] = _Model(1 << min(k, self.BITS_HIGH))
            if k <= self.BITS_HIGH:
                enc.symbol(m, raw)
            else:
                k1 = k - self.BITS_HIGH
                enc.symbol(m, raw >> k1)
                enc.raw_bits(k1, raw & ((1 << k1) - 1))
