"""Host formats the port keeps its own copies of."""
