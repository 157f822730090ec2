# Copy of hgtpu/align/native_verify.py; only the imports differ.
"""ctypes binding for the native (C++) variant-graph verifier.

Same search semantics as hgtpu.align.verify.GeneVerifier (bit-identical
exploration order); verifies flattened (read, start-proposal) batches
across native threads.  See native/verifier.cpp.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..db.catalog import GeneRef, VT_SINGLE, VT_DELETION, VT_INSERTION
from ..utils.dna import encode_seq

MAX_OPS = 256
_KINDS = ("mismatch", "deletion", "insertion")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                        "libhgtpu_native.so")
    try:
        lib = ctypes.CDLL(path)
        lib.hgtpu_gene_create
        lib.hgtpu_verify_batch
    except (OSError, AttributeError):
        _lib = False
        return False
    lib.hgtpu_gene_create.restype = ctypes.c_void_p
    lib.hgtpu_gene_destroy.argtypes = [ctypes.c_void_p]
    lib.hgtpu_verify_batch.restype = None
    _lib = lib
    return lib


def native_available() -> bool:
    return bool(_load())


def _i32p(a):
    return np.ascontiguousarray(a, np.int32).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int32))


def _i8p(a):
    return np.ascontiguousarray(a, np.int8).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int8))


def _i64p(a):
    return np.ascontiguousarray(a, np.int64).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64))


class NativeVerifier:
    """Holds the native gene tables; mirrors GeneVerifier's contract."""

    def __init__(self, gene: GeneRef, max_novel: int = 2,
                 allow_novel_indels: bool = True, threads: int = None,
                 haplotype_paths: bool = True):
        lib = _load()
        assert lib, "native library not built (make -C native)"
        self.lib = lib
        self.gene = gene
        self.max_novel = max_novel
        self.allow_novel_indels = allow_novel_indels
        self.threads = threads or min(8, os.cpu_count() or 1)

        singles = []
        dels_at = {}
        ins_at = {}
        for vi in range(gene.n_vars):
            vt = int(gene.var_type[vi])
            pos = int(gene.var_pos[vi])
            if vt == VT_SINGLE:
                singles.append((pos, "ACGT".index(gene.var_data[vi]), vi))
            elif vt == VT_DELETION:
                dels_at.setdefault(pos, []).append((int(gene.var_len[vi]),
                                                    vi))
            else:
                ins_at.setdefault(pos, []).append((gene.var_data[vi], vi))
        singles.sort()
        indel_pos = sorted(set(dels_at) | set(ins_at))
        d_start, d_end, i_start, i_end = [], [], [], []
        d_pos, d_len, d_vi = [], [], []
        i_pos, i_off, i_len, i_vi = [], [], [], []
        blob = []
        blob_len = 0
        for p in indel_pos:
            d_start.append(len(d_pos))
            for dl, vi in dels_at.get(p, ()):
                d_pos.append(p)
                d_len.append(dl)
                d_vi.append(vi)
            d_end.append(len(d_pos))
            i_start.append(len(i_pos))
            for seq, vi in ins_at.get(p, ()):
                codes = encode_seq(seq)
                i_pos.append(p)
                i_off.append(blob_len)
                i_len.append(len(codes))
                i_vi.append(vi)
                blob.append(codes)
                blob_len += len(codes)
            i_end.append(len(i_pos))
        ins_blob = np.concatenate(blob) if blob else np.zeros(1, np.int8)

        # keep arrays alive for the library's copy window
        bb = gene.backbone_enc
        s_pos = np.array([s[0] for s in singles], np.int32)
        s_base = np.array([s[1] for s in singles], np.int8)
        s_vi = np.array([s[2] for s in singles], np.int32)
        self.handle = ctypes.c_void_p(lib.hgtpu_gene_create(
            _i8p(bb), ctypes.c_int64(len(bb)),
            _i32p(s_pos), _i8p(s_base), _i32p(s_vi),
            ctypes.c_int64(len(singles)),
            _i32p(np.array(indel_pos, np.int32)),
            ctypes.c_int64(len(indel_pos)),
            _i32p(np.array(d_start, np.int32)),
            _i32p(np.array(d_end, np.int32)),
            _i32p(np.array(d_pos, np.int32)),
            _i32p(np.array(d_len, np.int32)),
            _i32p(np.array(d_vi, np.int32)),
            ctypes.c_int64(len(d_pos)),
            _i32p(np.array(i_start, np.int32)),
            _i32p(np.array(i_end, np.int32)),
            _i32p(np.array(i_pos, np.int32)),
            _i32p(np.array(i_off, np.int32)),
            _i32p(np.array(i_len, np.int32)),
            _i32p(np.array(i_vi, np.int32)),
            ctypes.c_int64(len(i_pos)),
            _i8p(ins_blob), ctypes.c_int64(len(ins_blob)),
        ))
        if haplotype_paths and gene.haplotypes \
                and hasattr(lib, "hgtpu_gene_set_hap"):
            from .verify import build_haplotype_constraint
            disallowed, cover_right = build_haplotype_constraint(gene)
            dis = sorted(disallowed)
            crs = sorted(cover_right.items())
            lib.hgtpu_gene_set_hap(
                self.handle,
                _i32p(np.array([u for u, _ in dis], np.int32)),
                _i32p(np.array([v for _, v in dis], np.int32)),
                ctypes.c_int64(len(dis)),
                _i32p(np.array([v for v, _ in crs], np.int32)),
                _i32p(np.array([r for _, r in crs], np.int32)),
                ctypes.c_int64(len(crs)))

    def __del__(self):
        try:
            if getattr(self, "handle", None) and self.lib:
                self.lib.hgtpu_gene_destroy(self.handle)
        except Exception:
            pass

    # ------------------------------------------------------------------ #
    def verify_raw(self, reads, starts):
        """reads: list of int8 code arrays; starts: int32 [n] (one start
        per entry; repeat a read for multiple proposals).

        Returns (cost [n] (-1 = fail), nops [n], ops [n, MAX_OPS, 5]).
        Use `ops_entries` to materialize a winner's edit script.
        """
        n = len(reads)
        if n == 0:
            return (np.empty(0, np.int32), np.empty(0, np.int32),
                    np.empty((0, MAX_OPS, 5), np.int32))
        blob = np.concatenate(reads).astype(np.int8)
        off = np.zeros(n, np.int64)
        lens = np.array([len(r) for r in reads], np.int32)
        np.cumsum(lens[:-1], out=off[1:])
        cost = np.empty(n, np.int32)
        nops = np.empty(n, np.int32)
        ops = np.empty((n, MAX_OPS, 5), np.int32)
        self.lib.hgtpu_verify_batch(
            self.handle, _i8p(blob), _i64p(off), _i32p(lens),
            _i32p(np.asarray(starts, np.int32)), ctypes.c_int64(n),
            ctypes.c_int32(self.max_novel),
            ctypes.c_int32(1 if self.allow_novel_indels else 0),
            ctypes.c_int32(self.threads),
            cost.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return cost, nops, ops

    @staticmethod
    def ops_entries(read, nops, ops_row):
        """Materialize one result's ops as GeneVerifier-style tuples."""
        return NativeVerifier.ops_entries_batch([read], [nops],
                                                [ops_row])[0]

    @staticmethod
    def ops_entries_batch(reads, nops, ops_rows):
        """Materialize many results' ops at once: one concatenated
        tolist() walk over the used rows replaces per-op numpy scalar
        extraction (measured ~49us/entry at IMGT depth — a read crossing
        a dozen catalog SNPs pays 5 numpy scalar reads per op)."""
        counts = [int(k) for k in nops]
        parts = [r[:k] for r, k in zip(ops_rows, counts) if k]
        flat = np.concatenate(parts).tolist() if parts else []
        out = []
        at = 0
        for read, k in zip(reads, counts):
            entries = []
            for _ in range(k):
                kind_i, pos, length, var, roff = flat[at]
                at += 1
                if kind_i == 0:
                    data = "ACGTN."[int(read[roff])]
                elif kind_i == 1:
                    data = str(length)
                else:
                    data = "".join("ACGTN."[int(c)]
                                   for c in read[roff:roff + length])
                entries.append((_KINDS[kind_i], pos, length, var, data))
            out.append(entries)
        return out

    def verify_flat(self, reads, starts):
        """Compatibility wrapper: (cost, ops lists or None)."""
        cost, nops, ops = self.verify_raw(reads, starts)
        out = [None if cost[i] < 0
               else self.ops_entries(reads[i], int(nops[i]), ops[i])
               for i in range(len(reads))]
        return cost, out
