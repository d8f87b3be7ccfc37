"""The probe plane: inventory, collective, GEMM and HBM probes, report, trend, agent."""
