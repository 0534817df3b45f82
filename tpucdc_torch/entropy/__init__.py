"""Host entropy coding: C++ rANS coder + bitstream container (formats v2–v5)."""

from tpucdc_torch.entropy.bitstream import (BitstreamHeader, read_bitstream,
                                            with_header_gamma,
                                            with_header_gamma_grid,
                                            write_bitstream)
from tpucdc_torch.entropy.rans import RansCodec, native_available

__all__ = ["RansCodec", "native_available", "BitstreamHeader",
           "read_bitstream", "write_bitstream", "with_header_gamma",
           "with_header_gamma_grid"]
