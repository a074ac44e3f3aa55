"""One reader a metric: ``<name with its dots as underscores>.py`` holds
``read(run) -> float | None`` (``record.Run``).  A reader that finds
nothing to read returns None, and the harness leaves the metric out."""
