"""The benchmark's reference: a frozen copy of the port's plain paths (the
kernels' plain versions, the pure-Python rANS coder), with every import
rewritten to this package. It imports nothing of the port, of JAX or of the
JAX package, and takes nothing the port made: it builds its own model from
the configuration file and the weights file, its own coder tables and its
own bitstreams."""
