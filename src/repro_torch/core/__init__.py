"""Core math of the port: attention, Loki selection, PCA, dispatch."""
