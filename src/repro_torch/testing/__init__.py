"""Count matrices and other helpers the port is checked and measured with."""
