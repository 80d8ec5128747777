"""Traffic drivers, one module a traffic ``kind``: ``drivers/<kind>.py``."""
