"""One-product routing of a read batch across a multi-gene panel (port
of hgtpu/align/panel.py).

The reference extracts/routes reads by aligning them against ONE spliced
index (genotype_genome or a family graph index) and binning by locus
interval (typing_process.py:1604-1716).  The router keeps that
one-index design:

  * all genes' PWMs are concatenated with a zero spacer wide enough that
    no diagonal window straddles two genes,
  * one placement product (kernel K1, ops.placement.correlate_scores)
    scores every (read, diagonal) pair over the whole panel (both
    orientations stacked),
  * a segment max over the window axis reduces to per-gene best scores
    [N, G] — the only thing fetched.

Downstream, full alignment runs only on each read's candidate genes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.placement import correlate_scores, backbone_pwm, encode_reads

# spacer rows between genes; reads longer than this are clipped for
# routing (typing reads are 100-300 bp)
SPACER = 512


def _panel_max(pwm_concat, bounds, reads):
    """Per-gene best window score [N, G]: the segment max of hgtpu's
    `jax.ops.segment_max(scores.T, seg_ids)`, without its trailing
    segment (the last spacer's windows).  Segment g is the contiguous
    column range bounds[g]:bounds[g + 1] of the scores; they are integers
    held in float32, so the max is exact in any order."""
    scores = correlate_scores(pwm_concat, reads)        # [N, P1]
    return torch.stack([scores[:, a:b].amax(dim=1)
                        for a, b in zip(bounds[:-2], bounds[1:-1])], dim=1)


class PanelRouter:
    def __init__(self, refs, pad_len: int = 128, device=None):
        """refs: ordered [(key, GeneRef)]."""
        self.keys = [k for k, _ in refs]
        self.pad_len = pad_len
        self.device = resolve_device(device)
        rows = []
        self.row_ends = []        # per gene: last row + 1 (segment bound)
        at = 0
        for _key, ref in refs:
            rows.append(np.zeros((SPACER, 5), np.float32))
            pwm = backbone_pwm(ref)
            at += SPACER
            rows.append(pwm)
            at += len(pwm)
            self.row_ends.append(at)
        rows.append(np.zeros((SPACER, 5), np.float32))
        self.pwm_concat = torch.from_numpy(
            np.concatenate(rows, axis=0)).to(self.device)
        self._row_ends = np.asarray(self.row_ends, np.int64)
        self._seg_cache = {}      # read length -> segment column bounds

    def _seg_ids(self, m):
        """Column bounds of the G + 1 window segments at read width m:
        segment g holds windows bounds[g]:bounds[g + 1]."""
        bounds = self._seg_cache.get(m)
        if bounds is None:
            P1 = self.pwm_concat.shape[0] - m + 1
            # window p covers rows p..p+m-1; with SPACER >= m a window
            # sees content of exactly one gene: the one whose row range
            # it reaches (searchsorted over gene end offsets)
            ids = np.searchsorted(self._row_ends, np.arange(P1),
                                  side="right")
            bounds = np.searchsorted(ids, np.arange(len(self.keys) + 2),
                                     side="left").tolist()
            self._seg_cache[m] = bounds
        return bounds

    _COMP = np.array([3, 2, 1, 0, 4, 5], dtype=np.int8)

    def gene_max(self, seqs):
        """Per-gene best diagonal score over both orientations.

        Returns (gene_max [N, G] float32, m [N] routed lengths).
        """
        n = len(seqs)
        clip = [s[:SPACER] for s in seqs]
        m = max(len(s) for s in clip)
        m = ((m + self.pad_len - 1) // self.pad_len) * self.pad_len
        m = min(m, SPACER)
        fwd = encode_reads(clip, m)
        lens = np.fromiter((min(len(s), m) for s in clip), np.int64, n)
        j = np.arange(m)
        rev = fwd[:, ::-1]
        idx = np.minimum(j[None, :] + (m - lens)[:, None], m - 1)
        rc = self._COMP[rev[np.arange(n)[:, None], idx]]
        rc[j[None, :] >= lens[:, None]] = 4
        both = np.concatenate([fwd, rc], axis=0)
        gm = _panel_max(self.pwm_concat, self._seg_ids(m),
                        torch.from_numpy(both).to(self.device))
        gm = gm.cpu().numpy()
        return np.maximum(gm[:n], gm[n:]), lens
