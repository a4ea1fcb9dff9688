"""DataMUX core: the mux/demux strategy registry and the retrieval
objective."""
