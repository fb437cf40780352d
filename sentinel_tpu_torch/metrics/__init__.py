"""The server's host metric planes (the port's copy of part of
``sentinel_tpu/metrics``): latency histograms, the HA counters, the
per-second timeline, the server metrics registry and the profiler hook.
The reference's metric log, extension SPI and Prometheus exporter are not
ported yet (ROADMAP)."""
