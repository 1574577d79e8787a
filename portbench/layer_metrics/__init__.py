"""One reader per per-layer metric, ``<metric>.py`` with ``read(obs)``: the
metric's value from the traced run's observations, or None where the run
has nothing to read (the harness then leaves the metric out).

``obs`` holds, of the untraced window, ``steps``, ``images`` and
``window_s`` (``_spans.py`` reads the program's spans of that window);
``trace`` (trace.reduce_events of the profiled window, with its
``steps``); ``cfg`` and ``traffic``.
"""
