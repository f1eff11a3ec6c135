"""The raster projection's counted work for one pass of a voxel-map
configuration, from the problem's shapes alone: O orientations of P = box³
voxels, each rotated and snapped (~20 f32 operations) and depositing E
weights (its disc, d² < r² at r = 2·pix: E = 9), in f32; the model read
once (20 bytes a voxel) and the (O, N, N) f32 projections written once.
Not a metric: ``raster_roofline`` reads it."""

from benchmark.counts import HBM_BYTES_PER_S, PEAK


def disc_entries(radius_px: float) -> int:
    """Pixels (du, dv) of a sphere's disc: du² + dv² < r² (r in pixels)."""
    s = int(radius_px) + 1
    return sum(1 for du in range(-s, s + 1) for dv in range(-s, s + 1)
               if du * du + dv * dv < radius_px ** 2)


def raster_work(prob) -> dict:
    """{"ops", "bytes", "bound_s"} of one pass; None where the
    configuration has no map."""
    spec = prob.cfg.get("map")
    if spec is None:
        return None
    o, p, n = prob.quats.shape[0], spec["box"] ** 3, prob.cfg["n_pixels"]
    ops = o * p * (20 + disc_entries(2.0))
    nbytes = 20 * p + 4 * o * n * n
    return {"ops": ops, "bytes": nbytes,
            "bound_s": max(ops / PEAK["f32"], nbytes / HBM_BYTES_PER_S)}
