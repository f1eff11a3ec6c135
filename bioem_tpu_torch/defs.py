"""Framework-wide constants and dtype policy (PyTorch port).

Mirrors the role of the reference's ``include/defs.h`` (defs.h:48-101):
float pixels, double probability accumulation, and the MIN_PROB sentinel
used to initialise running maxima. Same values as ``bioem_tpu.defs``;
torch needs no x64 switch, so there is no ``enable_x64``.
"""

from __future__ import annotations

import numpy as np

# Sentinel used to initialise running log-probability maxima
# (reference defs.h:65 `#define MIN_PROB -999999.`).
MIN_PROB = -999999.0

# Pixel / FFT dtype ("myfloat_t", reference defs.h:66).
FLOAT = np.float32
COMPLEX = np.complex64

# Probability-accumulation dtype ("myprob_t" with BIOEM_PROB_DOUBLE,
# reference defs.h:60): per-image accumulators and the per-(orientation,
# ctf, image) constants are float64; pixels stay float32.
PROB = np.float64

# Default output filenames (reference defs.h:42-46).
FILE_COORDREAD = "COORDREAD"
FILE_ANG_PROB = "ANG_PROB"
FILE_BESTMAP = "BESTMAP"
FILE_REFINED = "Output_Refined"  # framework extension: --Refine continuous polish
FILE_MAPS_DUMP = "maps.dump"
FILE_MODEL_DUMP = "model.dump"
DEFAULT_OUTPUT_FILE = "Output_Probabilities"

OUTPUT_PRECISION = 4  # reference defs.h:177
