"""The paper's tabular clustering workloads (port of ``repro.data``)."""
