'''Per-layer metrics, a reader a metric (metrics/<name>.py: read(data)).'''
