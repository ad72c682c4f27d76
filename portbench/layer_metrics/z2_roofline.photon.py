"""K1's share of its roofline [%] in the H-test: the least time of its
launches under the traced window's ``photon.htest`` spans
(``portbench.photon_roofline``: 16 B a photon at the memory bandwidth)
over their device time (``portbench.photon_trace``)."""

from portbench import photon_roofline, photon_trace


def read(ctx):
    k1 = photon_trace.k1_launches(ctx)
    if k1 is None:
        return None
    secs, n = k1
    d = ctx["dims"]
    return 100.0 * n * photon_roofline.z2_least_s(d["photons"], d["m"]) \
        / secs
