"""The command line: python -m tpucdc_torch compress|decompress|eval|rd-sweep."""
