"""Training token streams and the paper's tabular clustering workloads
(port of ``repro.data``)."""
