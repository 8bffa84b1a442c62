"""fuse_host_pct.*: the share of the backbone's host time that an HRNet's
exchange units take, in %: the program's ``fuse`` spans under
``<kind>.backbone`` over the ``<kind>.backbone`` spans, summed over the
traced run's device-only segment (:mod:`._spans`).  The BN calls of the
fuse terms run inside the ``fuse`` spans; the branches' blocks outside."""

from ._spans import ns, segment


def read(ctx):
    units, _ = segment(ctx)
    if not units:
        return None
    backbone = f"{units[0].kind}.backbone"
    fuse = [t for x in units for t in ns(x.spans, "fuse", parent=backbone)]
    whole = sum(t for x in units for t in ns(x.spans, backbone))
    if not fuse or whole <= 0:
        return None
    return 100.0 * sum(fuse) / whole
