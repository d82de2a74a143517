from rescan_line_sted_tpu.kernels.fftconv import (  # noqa: F401
    kernel_to_otf,
    convolve_otf,
    correlate_otf,
    fft_convolve,
    fft_correlate,
)
from rescan_line_sted_tpu.kernels.rescan_accumulate import (  # noqa: F401
    rescan_accumulate_reference,
)
