"""Analysis front end of the port: PCM batches, the main path, the tempo
finish."""
