"""Plain references: the data generator and the star-query evaluator."""
