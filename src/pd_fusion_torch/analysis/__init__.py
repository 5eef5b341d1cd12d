"""Analysis tier of the PPMI script suites (port of ``pd_fusion/analysis``)."""
