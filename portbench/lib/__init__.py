"""The yardstick: loading by name, traffic, peaks and work, trace reduction,
the import guard and the comparison that decides ``correct``."""
