"""Scripts that study the kernels on the card: SASS and ptxas reports
(`sass_report.py`) and timed variants of the GLOBAL traceback kernel
(`tb_variants.py`)."""
