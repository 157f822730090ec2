# Copy of hgtpu/tools/codis_fetch.py.
"""CODIS STR data fetcher — STRBase HTML table extraction.

Equivalent of hisatgenotype_tools/hisatgenotype_extract_codis_data.py:
the reference wgets http://www.cstl.nist.gov/biotech/strbase/str_<L>.htm
per CODIS locus and scrapes each allele's repeat structure out of the
HTML tables into a ``<base>.dat`` TSV of ``locus\tallele\tstructure``
lines (extract_codis_data.py:61-141).

This environment has no egress, so the parser is the first-class piece:
``parse_strbase_html`` consumes saved STRBase pages (or any HTML dump in
the same table shape) and ``extract_codis_data`` reads them from a local
directory by default.  A urllib-based source is provided for networked
hosts; it is never invoked implicitly.

The output ``.dat`` feeds :mod:`.codis` (component #22) via
``read_codis_dat``.
"""
from __future__ import annotations

import os
import re

# the 13 CODIS core loci the reference scrapes
# (extract_codis_data.py:34-36)
CODIS_LOCI = ["CSF1PO", "FGA", "TH01", "TPOX", "VWA",
              "D3S1358", "D5S818", "D7S820", "D8S1179", "D13S317",
              "D16S539", "D18S51", "D21S11"]

# allele ids as STRBase prints them: 12, 9.3, 30.2, 15'', 47.2, 22(19.2)*
# (the reference's allele_re, extract_codis_data.py:70)
_ALLELE = re.compile(
    r"^\d+(?:\.\d+)?[\"']*(?:\(\d+(?:\.\d+)?\))?[\"']*\*?$")
# repeat structures after tag stripping: [ACGT]n blocks, bare runs,
# interleaved spaces (the reference's repeat_re, :77)
_STRUCT = re.compile(r"^(?:\[[ACGT]+\]\d*|[ACGT]+|\s)+$")
_TAG = re.compile(r"<[^>]*>")
_ROW = re.compile(r"<tr[^>]*>(.*?)(?:</tr>|(?=<tr))", re.S | re.I)
_CELL = re.compile(r"<t[dh][^>]*>(.*?)(?:</t[dh]>|(?=<t[dh])|$)",
                   re.S | re.I)


def _clean(cell: str) -> str:
    """Strip tags and entities the way the scraper does
    (extract_codis_data.py:108-121): <sub>4</sub> collapses to the bare
    count so '[TTTC]<sub>4</sub>' reads '[TTTC]4'."""
    s = _TAG.sub("", cell)
    s = s.replace("&nbsp;", "").replace("&quot;", "''")
    return s.strip()


def parse_strbase_html(html: str):
    """Extract [(allele_id, repeat_structure)] from one STRBase page.

    Scans every table row for an allele-id cell followed by a
    repeat-structure cell (the reference walks <tr>/<td> lines the same
    way, extract_codis_data.py:98-135).  Rows without both are skipped —
    STRBase pages interleave header/commentary rows freely.
    """
    out = []
    seen = set()
    for row in _ROW.finditer(html):
        cells = [_clean(c.group(1)) for c in _CELL.finditer(row.group(1))]
        allele_id = None
        for cell in cells:
            squeezed = cell.replace(" ", "")
            if allele_id is None:
                if squeezed and _ALLELE.match(squeezed):
                    allele_id = squeezed
                continue
            if cell and _STRUCT.match(cell) and re.search(r"[ACGT]", cell):
                if allele_id not in seen:
                    seen.add(allele_id)
                    out.append((allele_id, cell))
                break
    return out


def dir_source(html_dir: str):
    """Source reading saved pages ``<html_dir>/str_<locus>.htm``."""
    def fetch(locus: str) -> str:
        path = os.path.join(html_dir, "str_%s.htm" % locus)
        with open(path) as f:
            return f.read()
    return fetch


def url_source(base_url: str = "https://strbase.nist.gov/str_%s.htm",
               timeout: float = 30.0):
    """Networked source (the reference's wget, :42-55).  Only used when
    explicitly requested — this build environment has no egress."""
    def fetch(locus: str) -> str:
        from urllib.request import urlopen
        with urlopen(base_url % locus, timeout=timeout) as r:
            return r.read().decode("utf-8", "replace")
    return fetch


def extract_codis_data(out_path: str, source, loci=None, verbose=False):
    """Write the ``.dat`` TSV the downstream converter reads
    (locus, allele, structure per line — extract_codis_data.py:137-139).

    ``source`` maps a locus name to page HTML (dir_source/url_source).
    Loci whose page is missing are skipped with a note rather than
    failing the rest (offline dumps are often partial).
    """
    loci = list(loci) if loci else list(CODIS_LOCI)
    n_alleles = 0
    with open(out_path, "w") as out:
        for locus in loci:
            try:
                html = source(locus)
            except (OSError, ValueError) as e:
                if verbose:
                    print("codis-fetch: %s skipped (%s)" % (locus, e))
                continue
            alleles = parse_strbase_html(html)
            for allele_id, structure in alleles:
                out.write("%s\t%s\t%s\n" % (locus, allele_id, structure))
            n_alleles += len(alleles)
            if verbose:
                print("codis-fetch: %s -> %d alleles"
                      % (locus, len(alleles)))
    return n_alleles


def read_codis_dat(path: str):
    """Read a ``.dat`` back as {locus: [(allele, structure)]} — the input
    shape of :func:`.codis.codis_msa`."""
    table = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            locus, allele, structure = line.split("\t", 2)
            table.setdefault(locus, []).append((allele, structure))
    return table
