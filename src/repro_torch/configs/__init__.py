"""Model, mux and serving configs (the port's own copy of ``repro.configs``)."""
