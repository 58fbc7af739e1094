"""The YAML config tree and its composition."""
