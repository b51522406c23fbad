"""The (dp, mp) device mesh: sharded training and the decoy-sharded fold."""
