"""Tools of the port that no path of the system runs (the probe tool)."""
