"""Graph substrate: structure, builders, segment (GroupBy) primitives,
generators, datasets, ELL layout."""
