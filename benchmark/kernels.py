"""Which layer each device kernel of the program belongs to, by its symbol
name. A kernel that matches no stem counts as glue, so a renamed or fused
kernel still lands in some layer."""

LAYER_STEMS = {
    # K1/K3 (compare_fused_*), K4 (compare_batched_*)
    "compare": ("compare_fused", "compare_batched"),
    # K2, G3, G4, and cuFFT's kernels on the raster path
    "projection": ("project_kernel", "project_prologue_kernel", "raster_projection_kernel", "fft"),
}


def layer_of(name: str) -> str:
    low = name.lower()
    for layer, stems in LAYER_STEMS.items():
        if any(s in low for s in stems):
            return layer
    return "glue"


def seconds_by_layer(kernels) -> dict:
    """{layer: device seconds} of (name, start µs, end µs) kernels."""
    out = {"compare": 0.0, "projection": 0.0, "glue": 0.0}
    for name, a, b in kernels:
        out[layer_of(name)] += (b - a) * 1e-6
    return out
