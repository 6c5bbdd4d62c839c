"""Stream datasets of the port (the paper's §6.1 generators)."""
