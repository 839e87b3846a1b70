"""Operations and bytes worked out from shapes, and the card's peaks."""
