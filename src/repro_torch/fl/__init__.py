"""Federation: the wire codec, messages and the host ``Star`` session."""
