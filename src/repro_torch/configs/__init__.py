"""Model configurations the port serves (copied from ``src/repro/configs``)."""
