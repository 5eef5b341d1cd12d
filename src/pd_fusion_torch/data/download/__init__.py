"""Dev-dataset fetchers (port of ``pd_fusion/data/download``)."""
