"""The paper's comparison baselines, implemented: HOPE (Paillier-based,
stateless) and POPE (client-interactive partial order)."""
