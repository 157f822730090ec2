# Copy of hgtpu/assemble/pdf.py.
"""Assembly visualization PDF renderer.

Equivalent of the reference's hand-rolled PDF-1.7 writer
(hisatgenotype_assembly_graph.py:1746-2230): draws a backbone ruler,
allele tracks, per-node read/contig boxes (variant positions highlighted)
and the coverage profile, one panel per assembly stage.
"""
from __future__ import annotations

import zlib


class PdfCanvas:
    """Minimal single-page vector PDF writer."""

    def __init__(self, width, height):
        self.width = width
        self.height = height
        self.ops = []

    # drawing ops (PDF user space; y up)
    def rect(self, x, y, w, h, rgb=(0, 0, 0), fill=True):
        self.ops.append("%f %f %f %s" % (*rgb, "rg" if fill else "RG"))
        self.ops.append("%.2f %.2f %.2f %.2f re %s"
                        % (x, y, w, h, "f" if fill else "S"))

    def line(self, x1, y1, x2, y2, rgb=(0, 0, 0), lw=0.5):
        self.ops.append("%f %f %f RG %.2f w" % (*rgb, lw))
        self.ops.append("%.2f %.2f m %.2f %.2f l S" % (x1, y1, x2, y2))

    def text(self, x, y, s, size=8, rgb=(0, 0, 0)):
        esc = s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
        self.ops.append("BT %f %f %f rg /F1 %d Tf %.2f %.2f Td (%s) Tj ET"
                        % (*rgb, size, x, y, esc))

    def save(self, path):
        content = zlib.compress("\n".join(self.ops).encode("latin-1"))
        objs = []
        objs.append("<< /Type /Catalog /Pages 2 0 R >>")
        objs.append("<< /Type /Pages /Kids [3 0 R] /Count 1 >>")
        objs.append(
            "<< /Type /Page /Parent 2 0 R /MediaBox [0 0 %.0f %.0f] "
            "/Contents 4 0 R /Resources << /Font << /F1 5 0 R >> >> >>"
            % (self.width, self.height))
        objs.append(None)  # stream placeholder
        objs.append("<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
        out = bytearray(b"%PDF-1.7\n")
        offsets = []
        for i, obj in enumerate(objs, start=1):
            offsets.append(len(out))
            if obj is None:
                head = ("%d 0 obj\n<< /Length %d /Filter /FlateDecode >>\n"
                        "stream\n" % (i, len(content))).encode()
                out += head + content + b"\nendstream\nendobj\n"
            else:
                out += ("%d 0 obj\n%s\nendobj\n" % (i, obj)).encode()
        xref_at = len(out)
        out += ("xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)).encode()
        for off in offsets:
            out += ("%010d 00000 n \n" % off).encode()
        out += ("trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
                % (len(objs) + 1, xref_at)).encode()
        with open(path, "wb") as f:
            f.write(out)


def draw_assembly(path, backbone_len, panels, coverage=None, exons=()):
    """panels: [(title, [(node_id, left, right, [var positions][, seq])])].

    coverage: {allele: [0..1] * backbone_len} drawn under the ruler.
    At high zoom (short loci, e.g. CODIS STRs) node rows render their
    per-base nucleotide text, as the reference renderer does when zoomed
    (hisatgenotype_assembly_graph.py:1875-2230).
    """
    scale_x = 540.0 / max(1, backbone_len)
    show_bases = scale_x >= 4.0
    margin = 30
    row_h = 8 if show_bases else 5
    height = margin * 2 + 60
    for _t, nodes in panels:
        height += 30 + row_h * (len(nodes) + 2)
    if coverage:
        height += 40 * len(coverage)
    c = PdfCanvas(600, height)
    y = height - margin

    # ruler
    c.text(margin, y, "backbone (%d bp)" % backbone_len, size=9)
    y -= 12
    c.line(margin, y, margin + backbone_len * scale_x, y, lw=1.0)
    step = max(1, backbone_len // 10)
    for p in range(0, backbone_len + 1, step):
        x = margin + p * scale_x
        c.line(x, y - 2, x, y + 2)
        c.text(x - 6, y - 10, str(p), size=5)
    for el, er in exons:
        c.rect(margin + el * scale_x, y + 4, (er - el + 1) * scale_x, 3,
               rgb=(0.2, 0.5, 0.2))
    y -= 22

    if coverage:
        for allele, cov in coverage.items():
            c.text(margin, y, "coverage %s" % allele, size=7)
            y -= 4
            stride = max(1, len(cov) // 540)
            for p in range(0, len(cov), stride):
                h = 24 * cov[p]
                if h > 0:
                    c.rect(margin + p * scale_x, y - 24 + (24 - h),
                           max(0.4, stride * scale_x), h,
                           rgb=(0.6, 0.6, 0.9))
            y -= 32

    for title, nodes in panels:
        c.text(margin, y, title, size=10)
        y -= 14
        for entry in nodes:
            node_id, left, right, var_pos = entry[:4]
            seq = entry[4] if len(entry) > 4 else None
            c.rect(margin + left * scale_x, y - 3,
                   max(0.5, (right - left + 1) * scale_x), 3.5,
                   rgb=(0.75, 0.75, 0.75))
            for vp in var_pos:
                c.rect(margin + vp * scale_x, y - 3, max(0.5, scale_x), 3.5,
                       rgb=(0.85, 0.2, 0.2))
            if show_bases and seq:
                vset = set(var_pos)
                size = min(6, int(scale_x))
                for k, ch in enumerate(seq[: right - left + 1]):
                    p = left + k
                    c.text(margin + p * scale_x + 0.4, y - 2.4, ch,
                           size=size,
                           rgb=(0.7, 0.1, 0.1) if p in vset else (0, 0, 0))
            if len(nodes) <= 40:
                c.text(margin + right * scale_x + 4, y - 3,
                       str(node_id)[:40], size=4)
            y -= row_h
        y -= 16
    c.save(path)
    return path


def panel_from_nodes(graph, gene, nodes):
    out = []
    for node_id, node in sorted(nodes.items(),
                                key=lambda kv: (kv[1].left, kv[1].right)):
        var_pos = []
        for vid in node.get_var_ids():
            try:
                var_pos.append(int(gene.var_pos[gene.var_index(vid)]))
            except KeyError:
                pass
        try:
            seq = node.get_seq()
        except Exception:
            seq = None
        out.append((node_id, node.left, node.right, var_pos, seq))
    return out
