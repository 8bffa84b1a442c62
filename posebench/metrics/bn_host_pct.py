"""bn_host_pct.*: the share of the backbone's host time that its BN calls
take, in %: the program's ``bn`` spans under ``<kind>.backbone`` over the
``<kind>.backbone`` spans, summed over the traced run's device-only segment
(:mod:`._spans`)."""

from ._spans import ns, segment


def read(ctx):
    units, _ = segment(ctx)
    if not units:
        return None
    backbone = f"{units[0].kind}.backbone"
    bn = [t for x in units for t in ns(x.spans, "bn", parent=backbone)]
    whole = sum(t for x in units for t in ns(x.spans, backbone))
    if not bn or whole <= 0:
        return None
    return 100.0 * sum(bn) / whole
