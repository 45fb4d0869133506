"""Host-side helpers shared by the port's tiers."""
