# Copy of hgtpu/utils/io.py.
"""Sequence file I/O: FASTA/FASTQ readers and writers (gzip-aware).

Replaces the reference's ad-hoc parsing and gzip subprocess pipes
(typing_process.py:1495-1532).
"""
from __future__ import annotations

import gzip


def _open(path, mode="rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_fastx(path):
    """[(name, seq)] from FASTA or FASTQ (optionally .gz)."""
    with _open(path) as f:
        text = f.read()
    if not text:
        return []
    reads = []
    if text[0] == ">":
        for block in text.split(">")[1:]:
            lines = block.split("\n")
            reads.append((lines[0].split()[0], "".join(lines[1:]).strip()))
    elif text[0] == "@":
        lines = text.rstrip("\n").split("\n")
        for i in range(0, len(lines) - 1, 4):
            reads.append((lines[i][1:].split()[0], lines[i + 1].strip()))
    else:
        raise ValueError("unrecognized read file format: %s" % path)
    return reads


def write_fastq(reads, path):
    with _open(path, "wt") as f:
        for name, seq in reads:
            f.write("@%s\n%s\n+\n%s\n" % (name, seq, "I" * len(seq)))


def write_fasta_reads(reads, path):
    with _open(path, "wt") as f:
        for name, seq in reads:
            f.write(">%s\n%s\n" % (name, seq))
