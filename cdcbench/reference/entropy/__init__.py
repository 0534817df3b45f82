"""The reference's container reader and pure-Python rANS coder."""
