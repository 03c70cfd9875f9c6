"""FeatureBox core: operator DAG, layer-wise scheduling and the per-layer
device executables."""
