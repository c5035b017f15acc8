"""Runtime of the PyTorch port: serving inputs and the flow-routed
``ServeTrainer`` (``serving``), and the staged training runtime
(``stages``, ``activations``, ``cache``, ``recovery``, ``trainer``; port
of ``repro.core.runtime``)."""
