"""Tabular feature helpers (port of ``pd_fusion/features``; no pipeline of
either package calls them)."""
