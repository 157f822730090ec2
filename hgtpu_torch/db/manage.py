# Copy of hgtpu/db/manage.py; it calls the port's extract-vars.
"""Database management: build-if-missing wrappers with multiprocess
locking, and acquisition hooks.

Equivalent of typing_common.py:490-641 (clone_hisatgenotype_database,
download_genome_and_index, extract_database_if_not_exists,
build_index_if_not_exists, and the `locking` decorator guarding them).
Downloads require network egress; in offline environments they raise with
instructions instead of silently failing.
"""
from __future__ import annotations

import contextlib
import functools
import os

_DB_FILES = ["_backbone.fa", "_sequences.fa", ".snp", ".index.snp",
             ".snp.freq", ".link", ".haplotype", ".locus", ".allele",
             ".partial"]


@contextlib.contextmanager
def dir_lock(path):
    """File-based lock usable across processes (the reference uses one
    global multiprocessing.Lock, typing_common.py:47-57)."""
    os.makedirs(path, exist_ok=True)
    lock_path = os.path.join(path, ".hgtpu.lock")
    import fcntl

    with open(lock_path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def locking(fn):
    @functools.wraps(fn)
    def wrapped(ix_dir, *a, **kw):
        with dir_lock(ix_dir):
            return fn(ix_dir, *a, **kw)
    return wrapped


def database_exists(ix_dir, base) -> bool:
    prefix = os.path.join(ix_dir, base)
    return all(os.path.exists(prefix + s) for s in _DB_FILES)


@locking
def extract_database_if_not_exists(ix_dir, base, msf_dir=None,
                                   min_var_freq=0.1, **kw):
    """Build the family database from MSF alignments unless present
    (ref: extract_database_if_not_exists, typing_common.py:534-575)."""
    if database_exists(ix_dir, base):
        return False
    if msf_dir is None or not os.path.isdir(msf_dir):
        raise FileNotFoundError(
            "database '%s' missing in %s and no --msf-dir given; run "
            "`python -m hgtpu_torch.cli.toolkit extract-vars "
            "--msf-dir DIR --base %s --ix-dir %s`"
            % (base, ix_dir, base, ix_dir))
    from ..cli.toolkit import cmd_extract_vars

    cmd_extract_vars(["--msf-dir", msf_dir, "--base", base,
                      "--ix-dir", ix_dir,
                      "--min-var-freq", str(min_var_freq)])
    return True


def _fetch_into(ix_dir, source):
    """Pluggable acquisition: `source` may be a callable(ix_dir), a local
    directory (copied in), or a git URL/path (cloned — file:// and local
    .git work offline).  Returns True when it produced files."""
    import shutil
    import subprocess

    if source is None:
        return False
    if callable(source):
        source(ix_dir)
        return True
    if os.path.isdir(source) and not source.endswith(".git"):
        os.makedirs(ix_dir, exist_ok=True)
        for name in os.listdir(source):
            src = os.path.join(source, name)
            dst = os.path.join(ix_dir, name)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
        return True
    # git URL (the reference's clone path, typing_common.py:526-529);
    # file:// remotes and local bare repos work without egress
    r = subprocess.run(["git", "clone", "--depth", "1", source, ix_dir],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("fetch from %r failed: %s"
                           % (source, r.stderr.strip()[-500:]))
    return True


def clone_hisatgenotype_database(ix_dir, source=None):
    """The reference git-clones IMGT-derived data
    (typing_common.py:526-529).  `source` (or $HGTPU_DB_SOURCE) plugs in
    the acquisition: a directory to copy, a git URL/path to clone, or a
    callable — so offline environments point at local mirrors."""
    source = source or os.environ.get("HGTPU_DB_SOURCE")
    if _fetch_into(ix_dir, source):
        return ix_dir
    raise RuntimeError(
        "network access unavailable: place an MSF database under %s and use "
        "extract-vars, copy a prebuilt hgtpu/reference-format database "
        "directory, or set HGTPU_DB_SOURCE to a local mirror" % ix_dir)


def download_genome_and_index(ix_dir, source=None):
    """Ref: typing_common.py:495-512 (wget GRCh38 + prebuilt index).
    `source` (or $HGTPU_GENOME_SOURCE) plugs in a local mirror the same
    way as clone_hisatgenotype_database."""
    source = source or os.environ.get("HGTPU_GENOME_SOURCE")
    if _fetch_into(ix_dir, source):
        return ix_dir
    raise RuntimeError(
        "network access unavailable: provide a host genome FASTA via "
        "--genome and build with `toolkit build-genome`, or set "
        "HGTPU_GENOME_SOURCE to a local mirror")


def inspect(prefix, out=None):
    """Reconstruct allele FASTA from a database — the hisat2-inspect
    equivalent (component #4, invoked at typing_common.py:505)."""
    import sys

    from .catalog import import_text

    cat = import_text(os.path.basename(prefix), prefix)
    f = open(out, "w") if out else sys.stdout
    for gene in cat.genes.values():
        print(">%s" % gene.backbone_name, file=f)
        for s in range(0, len(gene.backbone), 60):
            print(gene.backbone[s:s + 60], file=f)
        for name in gene.allele_names:
            seq = gene.allele_seq(name)
            print(">%s" % name, file=f)
            for s in range(0, len(seq), 60):
                print(seq[s:s + 60], file=f)
    if out:
        f.close()
