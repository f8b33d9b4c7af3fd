"""Gossip, the minimax problem, DRGDA/DRSGDA and the M_t metric."""
