"""Architecture configs of the LM substrate and the paper's tuning workload
(copies of ``repro/configs``)."""
