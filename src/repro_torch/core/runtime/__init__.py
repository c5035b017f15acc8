"""Runtime of the PyTorch port: serving inputs."""
