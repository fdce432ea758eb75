"""Host observability: the metrics registry, per-tick phase clocks, the
crash flight recorder, Prometheus text (``prom``), the scrape endpoint
(``http``) and the scenario timeline (``timeline``)."""
