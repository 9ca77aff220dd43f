"""Host-side fleet state: interning, columnar packing, resident fleet."""
