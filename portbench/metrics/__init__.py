"""One reader per metric: ``<name>.py`` holds ``read(ctx)``, which returns
the metric's value or None where the run has nothing to read for it.
``ctx`` carries the configuration (``cfg``, ``n``), the jobs that
answered in the window (``jobs``, each with ``latency_s`` and host-clock
``spans``), ``window_s``, ``setup_s``, ``peak_bytes``, ``gc`` (the
window's ``harness.GcClock``) and, in a traced run, ``trace``
(``trace_math.TraceView`` of the window)."""
