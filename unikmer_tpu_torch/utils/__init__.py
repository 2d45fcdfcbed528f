"""Host utilities of the port: logging (log.py) and stage timing (stages.py)."""
