"""The benchmark harness of the PyTorch port: the manifest, the request
stream, the coreset program, the window and the run, the verdict, the
frozen yardsticks and the trace reading.  ``bench/run.py`` is its entry
point; what belongs to one configuration, mix, loop, engine, judge or
metric lives in a file of its own beside this package."""
