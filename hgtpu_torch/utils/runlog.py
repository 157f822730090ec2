# Copy of hgtpu/utils/runlog.py.
"""Date-stamped run log with per-gene/per-sample failure tracebacks.

Mirror of the reference's error-log pass: after the per-sample
pool drains, `hisatgenotype:670-680` writes `<date>_hisat-genotype.log`
with one "> Base and Files:" entry per job holding either the result
or the captured `traceback.format_exc()`.  Here the log is appended
live (one process, streaming) so a crash mid-run still leaves entries.
"""
from __future__ import annotations

import datetime
import os
import threading
import traceback


class RunLog:
    """Append-only run log: `<out_dir>/<YYYY-MM-DD>_hgtpu.log`."""

    def __init__(self, out_dir="."):
        self.path = os.path.join(
            out_dir, "%s_hgtpu.log" % datetime.date.today())
        self._lock = threading.Lock()

    def entry(self, label, text):
        with self._lock:
            with open(self.path, "a") as f:
                f.write("> Base and Files:%s\n%s\n" % (label, text))

    def exception(self, label):
        """Record the active exception under `label`; returns the
        formatted traceback (ref: hisatgenotype:675-678)."""
        err = traceback.format_exc()
        self.entry(label, err)
        return err
