"""kernels_roofline.<family>: the port's fmul, padd, pdbl, finv and
rho_round together against their least time, 100 x (sum over their
launches of the least time) / (their profiler device time).  The launches
and their widths come from the port's launch counters over the window,
the least time per launch from costs.launch_least_seconds at the SM
clock read after the window.  None where the window launched none of
them."""

from portbench import costs


def read(td):
    least = 0.0
    for k in costs.ROOFLINE_KERNELS:
        for width, count in td.launch_widths.get(k, {}).items():
            least += count * costs.launch_least_seconds(k, width, td.sm_mhz)
    spent = sum(t - s for s, t, n in td.device if td.kernel_of(n) in costs.ROOFLINE_KERNELS)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
