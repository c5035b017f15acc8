"""Flow planner of the PyTorch port: copies of ``repro.core.flow``'s
``graph``, ``decentralized``, ``mincost`` and ``reference``."""
