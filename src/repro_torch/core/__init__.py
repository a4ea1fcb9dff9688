"""DataMUX core: the mux/demux strategy registry."""
