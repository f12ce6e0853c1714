"""Operations and bytes of the measured work, computed from shapes alone."""
