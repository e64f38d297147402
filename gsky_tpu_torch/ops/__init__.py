"""ops: device compute — warp, scaling and the hand-written kernels."""


def kernel_launches() -> dict:
    """This process's launch count of each kernel wrapper, by symbol:
    ``worker_info``'s and the OWS server's ``/debug`` ``kernels``."""
    from . import first_valid, stats, warp_render
    out = {}
    for k in (warp_render.paged_render_kernel,
              warp_render.warp_render_kernel,
              stats.masked_stats_kernel, stats.masked_stats_many_kernel,
              first_valid.first_valid_kernel):
        out[k.symbol] = k.launches
    return out
