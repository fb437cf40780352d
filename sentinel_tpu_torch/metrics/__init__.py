"""The server's host metric planes (the port's copy of part of
``sentinel_tpu/metrics``): latency histograms, the HA counters, the
per-second timeline, the server metrics registry, the profiler hook, the
stat logger and the metric extension SPI of the local engine's statistic
slot. The reference's metric log and Prometheus exporter are not ported yet
(ROADMAP)."""
