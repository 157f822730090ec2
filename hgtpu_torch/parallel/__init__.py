"""The production typing path on one device (port of hgtpu/parallel).

``e2e.ShardedTyper`` holds one gene's device tables and its place, spell
and count passes; ``production.type_reads_device`` runs them and rescues
the punt mask through the host engine.  One device, no mesh: many devices
come with ``torch.distributed`` (ROADMAP item 12).
"""
