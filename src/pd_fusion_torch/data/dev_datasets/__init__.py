"""Loaders of the public development datasets (UCI voice, OpenNeuro BIDS
participants tables): local files under ``paths.DEV_DATA_DIR`` ->
(frame, masks) in the canonical multimodal format."""
