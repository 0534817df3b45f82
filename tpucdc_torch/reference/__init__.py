"""Plain references of the port's models that have no JAX counterpart: f32
PyTorch written from the published equations, importing nothing of the
port. The tests hold the port to them."""
